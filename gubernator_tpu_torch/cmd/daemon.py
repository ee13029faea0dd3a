"""The gubernator_tpu_torch daemon binary.

Run:  python -m gubernator_tpu_torch.cmd.daemon [--device cuda|cpu] [--debug]
Env:  GUBER_HTTP_ADDRESS (default localhost:80), GUBER_CACHE_SIZE,
      GUBER_SWEEP_INTERVAL (default 30s), GUBER_SKETCH_WINDOW (default 1s),
      GUBER_SKETCH_DEPTH (default 4), GUBER_SKETCH_WIDTH (default 2^20),
      GUBER_H2_FAST_ADDRESS (the native h2 front, e.g. 127.0.0.1:0; default
      off), GUBER_H2_FAST_WINDOW (default 2ms), GUBER_H2_LANES.

Serves GetRateLimits over HTTP/JSON, and over cleartext HTTP/2 gRPC at
/pb.gubernator.V1/GetRateLimits when the h2 front is on, until SIGINT or
SIGTERM, then closes the listeners and the engine and exits 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator_tpu_torch daemon")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-debug", "--debug", action="store_true", help="debug logging")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import spawn_daemon

    stop = threading.Event()

    def _shutdown(signum, frame):
        logging.getLogger("gubernator_tpu_torch").info("signal %s: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)
    daemon = spawn_daemon(setup_daemon_config(), device=args.device)
    # Readiness line for supervisors and scripts: the bound addresses.
    line = f"listening http={daemon.http_address}"
    if daemon.h2_fast_address:
        line += f" h2={daemon.h2_fast_address}"
    print(line, flush=True)
    try:
        stop.wait()
    finally:
        daemon.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
