"""The gubernator_tpu_torch daemon binary.

Run:  python -m gubernator_tpu_torch.cmd.daemon [-config FILE] [--device cuda|cpu] [-debug]
      -config FILE: KEY=VALUE lines (# comments and blank lines skipped),
      exported into the environment before anything reads the config;
      its keys win over the process environment.
Env:  GUBER_DEBUG (1 / true / yes: debug logging, as -debug),
      GUBER_STATUS_HTTP_ADDRESS (a plain-HTTP listener serving health and
      /metrics; default off), GUBER_METRIC_FLAGS (os, python, golang, all:
      process / GC / platform families on /metrics),
      GUBER_HTTP_ADDRESS (default localhost:80), GUBER_CACHE_SIZE,
      GUBER_SWEEP_INTERVAL (default 30s), GUBER_SKETCH_WINDOW (default 1s),
      GUBER_SKETCH_DEPTH (default 4), GUBER_SKETCH_WIDTH (default 2^20),
      GUBER_H2_FAST_ADDRESS (the native h2 front, e.g. 127.0.0.1:0; default
      off), GUBER_H2_FAST_WINDOW (default 2ms), GUBER_H2_LANES,
      GUBER_LEDGER (default on), GUBER_LEDGER_LEASE (512),
      GUBER_LEDGER_LEASE_TTL (0.2s), GUBER_LEDGER_HOT_THRESHOLD (8),
      GUBER_LEDGER_KEYS (65536), GUBER_LEDGER_SETTLE_INTERVAL (0.05s),
      GUBER_NATIVE_LEDGER (default on), GUBER_NATIVE_FEEDER (the h2
      front's columnar feeder, default on), GUBER_FEEDER_RING_SLOTS (4),
      GUBER_FEEDER_RING_ROWS (8192), GUBER_FEEDER_RING_KEYBYTES (2^20),
      GUBER_RETRY_HINTS (default on), GUBER_LOG_LEVEL (trace|debug|info|
      warn|error), GUBER_LOG_FORMAT (text|json: JSON lines carry the trace
      id), GUBER_TRACING=memory (the in-memory tracer; OTEL_* for OTLP
      where its packages exist), GUBER_TRACE_TAIL_FACTOR (4),
      GUBER_TRACE_TAIL_MIN_MS (5), GUBER_TRACE_TAIL_CAP (64),
      GUBER_METRICS_EXEMPLARS (on), GUBER_HOTKEYS (on), GUBER_NATIVE_EVENTS
      (on), GUBER_NATIVE_EVENTS_CAP (65536), GUBER_NATIVE_EVENTS_INTERVAL
      (50ms), GUBER_OBS (on), GUBER_SLO_INTERVAL (5s), GUBER_SLO_FLEET,
      GUBER_SLO_FAST_WINDOWS / GUBER_SLO_SLOW_WINDOWS, GUBER_SLO_WATCH_KEYS,
      and the peer planes' keys (config.py), of which the daemon accepts only
      GUBER_PEER_DISCOVERY_TYPE=none and static peers naming itself.

Serves GetRateLimits over HTTP/JSON with /metrics beside it, and over cleartext HTTP/2 gRPC at
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
    parser.add_argument("-config", "--config", default="", help="KEY=VALUE environment file")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-debug", "--debug", action="store_true", help="debug logging")
    args = parser.parse_args(argv)
    from gubernator_tpu_torch.config import load_env_file, setup_daemon_config

    if args.config:
        # First: the file's keys reach every later reader of the
        # environment (logging, tracing, the engine's own knobs).
        load_env_file(args.config)
    from gubernator_tpu_torch.utils.logging_setup import configure_logging

    configure_logging(debug=args.debug)

    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.utils.tracing import init_tracing, shutdown_tracing

    init_tracing()
    conf = setup_daemon_config(config_file=args.config or None)
    if conf.debug and not args.debug:
        configure_logging(debug=True)  # GUBER_DEBUG=true is -debug
    log = logging.getLogger("gubernator_tpu_torch")
    if args.config:
        log.debug("config file %s loaded", args.config)

    stop = threading.Event()

    def _shutdown(signum, frame):
        log.info("signal %s: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)
    daemon = spawn_daemon(conf, device=args.device)
    # Readiness line for supervisors and scripts: the bound addresses.
    line = f"listening http={daemon.http_address}"
    if daemon.h2_fast_address:
        line += f" h2={daemon.h2_fast_address}"
    if daemon.status_gateway is not None:
        line += f" status={daemon.status_gateway.address}"
    print(line, flush=True)
    try:
        stop.wait()
    finally:
        daemon.close()
        shutdown_tracing()
    return 0


if __name__ == "__main__":
    sys.exit(main())
