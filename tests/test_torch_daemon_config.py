"""The port daemon's config against the JAX daemon's: the `-config`
file, GUBER_DEBUG, the peer planes' keys and the single-node guard.

Both binaries' `main` read one env file (their `spawn_daemon` replaced by
a stub that keeps the config and stops); every field of the port's
`DaemonConfig` (its `behaviors` field by field) must equal the
reference's field of the same name, and the root logger's level must be
the same.  `setup_daemon_config` is held to the reference's precedence
(file over `env` over os.environ) and validation errors, `load_env_file`
to its grammar and its bad-line error.  A config that makes the node one
of several is refused at start, naming ROADMAP A entries 3-4.  Last, the
port binary runs as a process with `-config` on the CPU, serving its
status listener.  The port's modules load no grpc and no
prometheus_client.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

import gubernator_tpu.cmd.daemon as ref_cmd
import gubernator_tpu.config as ref_config
import gubernator_tpu.daemon as ref_daemon_mod
import gubernator_tpu_torch.cmd.daemon as port_cmd
import gubernator_tpu_torch.config as port_config
import gubernator_tpu_torch.daemon as port_daemon_mod
from gubernator_tpu.utils import tracing as ref_tracing
from gubernator_tpu_torch.config import DaemonConfig, load_env_file, setup_daemon_config
from gubernator_tpu_torch.daemon import check_single_node, spawn_daemon
from gubernator_tpu_torch.utils import tracing as port_tracing

ROOT = Path(__file__).resolve().parent.parent

# Every key either package reads here, most at a value other than its
# default.
ENV_FILE = """\
# the daemon's settings
GUBER_HTTP_ADDRESS=127.0.0.1:9080

GUBER_CACHE_SIZE=12345
GUBER_SWEEP_INTERVAL=1m30s
GUBER_SKETCH_WINDOW=250ms
GUBER_SKETCH_DEPTH=3
GUBER_SKETCH_WIDTH=4096
GUBER_H2_FAST_ADDRESS=127.0.0.1:9081
GUBER_H2_FAST_WINDOW=500us
GUBER_H2_LANES=2
GUBER_LEDGER=off
GUBER_LEDGER_LEASE=64
GUBER_LEDGER_LEASE_TTL=1s
GUBER_LEDGER_HOT_THRESHOLD=4
GUBER_LEDGER_KEYS=1024
GUBER_LEDGER_SETTLE_INTERVAL=0
GUBER_NATIVE_LEDGER=0
GUBER_DEVICE_COUNT=2
GUBER_STATUS_HTTP_ADDRESS=127.0.0.1:9082
GUBER_METRIC_FLAGS=os, python
GUBER_ADAPTIVE_WINDOWS=false
GUBER_CIRCUIT_FAILURES=5
GUBER_CIRCUIT_BACKOFF=250ms
GUBER_CIRCUIT_BACKOFF_CAP=10s
GUBER_FORWARD_BACKOFF=5ms
GUBER_FORWARD_BACKOFF_CAP=1s
GUBER_PEER_PICKER=consistent-hash
GUBER_REPLICATED_HASH_REPLICAS=64
GUBER_STATIC_PEERS=127.0.0.1:9080, 127.0.0.1:9081
GUBER_DATA_CENTER=dc-east
GUBER_MEMBERLIST_ADDRESS=127.0.0.1:7946
GUBER_MEMBERLIST_KNOWN_NODES=10.0.0.1:7946,10.0.0.2:7946
GUBER_MEMBERLIST_ADVERTISE_PORT=7000
GUBER_DNS_FQDN=guber.svc.local
GUBER_DNS_POLL_INTERVAL=30s
GUBER_ETCD_ENDPOINTS=10.0.0.9:2379
GUBER_ETCD_KEY_PREFIX=/guber/
GUBER_ETCD_DIAL_TIMEOUT=2s
GUBER_ETCD_USER=u
GUBER_ETCD_PASSWORD=p
GUBER_ETCD_ADVERTISE_ADDRESS=10.0.0.1:1051
GUBER_ETCD_TLS_CA=/ca.pem
GUBER_ETCD_TLS_CERT=/c.pem
GUBER_ETCD_TLS_KEY=/k.pem
GUBER_ETCD_TLS_SKIP_VERIFY=true
"""

KEYS = [line.split("=", 1)[0] for line in ENV_FILE.splitlines()
        if line and not line.startswith("#")] + ["GUBER_DEBUG", "GUBER_PEER_PICKER_HASH",
                                                 "GUBER_PEER_DISCOVERY_TYPE"]


@pytest.fixture
def clean_env(monkeypatch):
    """The GUBER_* keys these tests set: unset before, restored after
    (load_env_file writes os.environ itself); the root logger and both
    tracers as they were."""
    for k in KEYS:
        monkeypatch.delenv(k, raising=False)
    saved = dict(os.environ)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        yield monkeypatch
    finally:
        os.environ.clear()
        os.environ.update(saved)
        root.setLevel(level)
        root.handlers[:] = handlers
        ref_tracing.shutdown_tracing()
        port_tracing.shutdown_tracing()


class _Spawned(Exception):
    def __init__(self, conf):
        self.conf = conf


def _run_main(monkeypatch, main, daemon_mod, argv):
    """`main(argv)` up to its spawn_daemon: the config it built, and the
    root logger's level then."""
    def fake_spawn(conf, **kw):
        raise _Spawned(conf)

    monkeypatch.setattr(daemon_mod, "spawn_daemon", fake_spawn)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    saved = dict(os.environ)
    try:
        main(argv)
    except _Spawned as e:
        return e.conf, logging.getLogger().level
    finally:
        os.environ.clear()
        os.environ.update(saved)
    raise AssertionError("main returned without spawning")


def _assert_fields_equal(port, ref):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "behaviors":
            for bf in dataclasses.fields(got):
                assert getattr(got, bf.name) == getattr(want, bf.name), bf.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("debug", ["", "true", "1", "yes", "no"])
@pytest.mark.parametrize("flag", [False, True])
def test_both_binaries_read_one_env_file_alike(clean_env, tmp_path, debug, flag):
    path = tmp_path / "guber.env"
    path.write_text(ENV_FILE + (f"GUBER_DEBUG={debug}\n" if debug else ""))
    argv = ["-config", str(path)] + (["-debug"] if flag else [])
    ref_conf, ref_level = _run_main(clean_env, ref_cmd.main, ref_daemon_mod, argv)
    port_conf, port_level = _run_main(clean_env, port_cmd.main, port_daemon_mod,
                                      argv + ["--device", "cpu"])
    _assert_fields_equal(port_conf, ref_conf)
    assert port_conf.cache_size == 12345 and port_conf.hash_algorithm == "fnv1a"
    assert port_conf.debug is (debug in ("true", "1", "yes"))
    assert port_level == ref_level
    assert port_level == (logging.DEBUG if flag or port_conf.debug else logging.INFO)


def test_defaults_equal_the_reference(clean_env):
    _assert_fields_equal(setup_daemon_config(), ref_config.setup_daemon_config())
    assert DaemonConfig().behaviors == port_config.BehaviorConfig()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_file_wins_over_env_which_wins_over_os_environ(clean_env, tmp_path, pkg):
    clean_env.setenv("GUBER_CACHE_SIZE", "1")
    clean_env.setenv("GUBER_SKETCH_DEPTH", "7")
    clean_env.setenv("GUBER_DNS_FQDN", "os.local")
    path = tmp_path / "f.env"
    path.write_text("GUBER_CACHE_SIZE=3\n")
    env = {"GUBER_CACHE_SIZE": "2", "GUBER_SKETCH_DEPTH": "8"}
    if pkg == "ref":
        conf = ref_config.setup_daemon_config(str(path), env)
    else:
        conf = setup_daemon_config(env, config_file=str(path))
    assert (conf.cache_size, conf.sketch_depth, conf.dns_fqdn) == (3, 8, "os.local")
    assert os.environ["GUBER_CACHE_SIZE"] == "3"  # the file's keys are exported


@pytest.mark.parametrize("env", [
    {"GUBER_PEER_PICKER": "ring"},
    {"GUBER_PEER_PICKER_HASH": "md5"},
    {"GUBER_PEER_DISCOVERY_TYPE": "zookeeper"},
    {"GUBER_CIRCUIT_BACKOFF": "5 parsecs"},
    {"GUBER_DNS_POLL_INTERVAL": "soon"},
])
def test_validation_errors_match_the_reference(clean_env, env):
    with pytest.raises(ValueError) as want:
        ref_config.setup_daemon_config(None, env)
    with pytest.raises(ValueError) as got:
        setup_daemon_config(env)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("picker,hash_env,want", [
    (None, None, "fnv1"), ("replicated-hash", None, "fnv1a"),
    ("consistent-hash", "fnv1", "fnv1"), (None, "fnv1a", "fnv1a")])
def test_picker_hash_default_depends_on_the_picker(clean_env, picker, hash_env, want):
    env = {k: v for k, v in (("GUBER_PEER_PICKER", picker),
                             ("GUBER_PEER_PICKER_HASH", hash_env)) if v}
    assert setup_daemon_config(env).hash_algorithm == want
    assert ref_config.setup_daemon_config(None, env).hash_algorithm == want


@pytest.mark.parametrize("load", [ref_config.load_env_file, load_env_file])
def test_env_file_grammar_and_bad_line(clean_env, tmp_path, load):
    path = tmp_path / "g.env"
    path.write_text("# comment\n\n  GUBER_A = x=y  \n#GUBER_B=1\nGUBER_C=\n")
    assert load(str(path)) == {"GUBER_A": "x=y", "GUBER_C": ""}
    assert os.environ["GUBER_A"] == "x=y"
    path.write_text("GUBER_A=1\n# fine\nGUBER_BROKEN\n")
    with pytest.raises(ValueError, match=rf"^{path}:3: expected KEY=VALUE$"):
        load(str(path))


@pytest.mark.parametrize("conf", [
    DaemonConfig(peer_discovery_type="member-list"),
    DaemonConfig(peer_discovery_type="dns", dns_fqdn="x.local"),
    DaemonConfig(peer_discovery_type="etcd"),
    DaemonConfig(peer_discovery_type="k8s"),
    DaemonConfig(http_listen_address="127.0.0.1:0", static_peers=["10.0.0.2:81"]),
    DaemonConfig(http_listen_address="127.0.0.1:0",
                 static_peers=["127.0.0.1:0", "127.0.0.1:9999"]),
])
def test_multi_node_config_is_refused_at_start(conf):
    with pytest.raises(ValueError, match="ROADMAP A entries 3-4"):
        check_single_node(conf)
    with pytest.raises(ValueError, match="ROADMAP A entries 3-4"):
        spawn_daemon(dataclasses.replace(conf, cache_size=64, sweep_interval=0.0),
                     device="cpu")


def test_static_peers_naming_only_itself_start():
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64, sweep_interval=0.0,
                        static_peers=["127.0.0.1:0"])
    check_single_node(conf)
    d = spawn_daemon(conf, device="cpu")
    d.close()


def test_port_loads_no_grpc_and_no_prometheus_client():
    probe = (
        "import importlib, json, pkgutil, sys\n"
        "import gubernator_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "print(json.dumps({'names': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    new = {f"gubernator_tpu_torch.{m}" for m in (
        "cluster", "cluster.hash_ring", "cluster.health", "cluster.faults",
        "cluster.batch_loop", "discovery", "discovery.base", "discovery.dns",
        "discovery.kubernetes", "discovery.memberlist", "discovery.etcd",
        "utils.exposition", "utils.metrics", "net.gateway", "cmd.daemon", "config")}
    assert new <= set(got["names"])
    banned = ("grpc", "prometheus_client", "jax", "jaxlib", "gubernator_tpu")
    assert [m for m in got["loaded"] if m.split(".")[0] in banned] == []


def test_binary_with_config_file_on_the_cpu(tmp_path):
    """`python -m gubernator_tpu_torch.cmd.daemon -config FILE`: the
    file's keys take effect (its status listener serves health and
    /metrics with the os flag's families), GUBER_DEBUG=true logs at
    DEBUG, and SIGTERM ends it with 0."""
    path = tmp_path / "d.env"
    path.write_text("GUBER_HTTP_ADDRESS=127.0.0.1:0\nGUBER_STATUS_HTTP_ADDRESS=127.0.0.1:0\n"
                    "GUBER_CACHE_SIZE=1024\nGUBER_SWEEP_INTERVAL=0\nGUBER_DEBUG=true\n"
                    "GUBER_METRIC_FLAGS=os\nGUBER_OBS=0\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon",
                             "-config", str(path), "--device", "cpu"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening http=127.0.0.1:"), line
        fields = dict(kv.split("=", 1) for kv in line.split()[1:])
        status = fields["status"]
        with urllib.request.urlopen(f"http://{status}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "healthy"
        with urllib.request.urlopen(f"http://{status}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "# TYPE gubernator_check_counter_total counter" in text
        assert "# TYPE process_resident_memory_bytes gauge" in text
        assert "python_info" not in text
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert f"DEBUG gubernator_tpu_torch config file {path} loaded" in err
