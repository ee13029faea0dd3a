"""The gubernator_tpu_torch daemon binary.

Run:  python -m gubernator_tpu_torch.cmd.daemon [--device cuda|cpu] [--debug]
Env:  GUBER_HTTP_ADDRESS (default localhost:80), GUBER_CACHE_SIZE,
      GUBER_SWEEP_INTERVAL (default 30s), GUBER_SKETCH_WINDOW (default 1s),
      GUBER_SKETCH_DEPTH (default 4), GUBER_SKETCH_WIDTH (default 2^20).

Serves GetRateLimits over HTTP/JSON until SIGINT or SIGTERM, then
closes the listener and the engine and exits 0.
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
    # Readiness line for supervisors and scripts: the bound address.
    print(f"listening http={daemon.http_address}", flush=True)
    try:
        stop.wait()
    finally:
        daemon.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
