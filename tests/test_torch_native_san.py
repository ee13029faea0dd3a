"""Sanitizer builds of the port's own native code (ops/native_build.py
GUBER_NATIVE_SAN) and the threaded stresses that run under them.

Tier-1: `san_mode` and `sanitizer_preload` equal the reference's
(gubernator_tpu/core/native_build.py:32 / :45); a sanitized build gets a
library name of its own and leaves the plain one; the `.cu` libraries
ignore the variable; a process without the runtime preloaded refuses to
load a sanitized library; malformed request bodies get the reference's
decode and the reference front's answer; and a feeder claim on a window
the serve thread already recycled is served (ROADMAP C5), with that race
widened by a sleep in a copy of the sources.

`slow` (`python -m pytest -m slow tests/test_torch_native_san.py`): the
reference's stresses (tests/test_h2_server_san.py:157 threaded and
reactor fronts, :375 the feeder, :426 the decision plane) and
`git_multi_schedule`'s pool against its serial run
(tests/test_multi_schedule.py:137), each under ThreadSanitizer and under
AddressSanitizer, and the malformed bodies through the codec, the plane
and the front under AddressSanitizer.  Each runs in a child process that
has the runtime in LD_PRELOAD and never forks once its C threads run; the
parent, unsanitized, builds the libraries and drives the front with the
port's native client (chip_smoke.py `san_host_stress`, which the san
phase of chip_smoke.py runs on the card's machine too).
"""

from __future__ import annotations

import importlib.util
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gubernator_tpu.core import native_build as ref_build
from gubernator_tpu.core import native_plane as ref_plane
from gubernator_tpu.net import h2_fast as ref_h2
from gubernator_tpu.net import wire_codec as ref_codec
from gubernator_tpu.service import COLUMNAR_DISQUALIFIERS as REF_DISQUALIFIERS
from gubernator_tpu_torch.core import native_plane
from gubernator_tpu_torch.net import h2_fast, wire_codec
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.mark.parametrize("value", ["", "0", "off", "none", "OFF", " None ", "1", "thread",
                                   "tsan", "TSan", " thread ", "address", "asan", "ASAN",
                                   "memory", "yes", "2"])
def test_san_mode_equals_the_reference(monkeypatch, value):
    monkeypatch.setenv("GUBER_NATIVE_SAN", value)
    assert native_build.san_mode() == ref_build.san_mode()
    monkeypatch.delenv("GUBER_NATIVE_SAN")
    assert native_build.san_mode() == ref_build.san_mode() == ""


@pytest.mark.parametrize("mode,lib", [("thread", "libtsan.so"), ("address", "libasan.so")])
def test_sanitizer_preload_finds_the_runtimes(monkeypatch, mode, lib):
    monkeypatch.delenv("GUBER_NATIVE_SAN", raising=False)
    path = native_build.sanitizer_preload(mode)
    assert path is not None and Path(path).name == lib and Path(path).exists()
    assert path == ref_build.sanitizer_preload(mode)
    assert native_build.sanitizer_preload("") is None
    assert native_build.sanitizer_preload() is None  # the variable unset: off
    monkeypatch.setenv("GUBER_NATIVE_SAN", mode)
    assert native_build.sanitizer_preload() == path


def test_a_sanitized_build_has_a_name_of_its_own(monkeypatch, tmp_path):
    """Plain, thread and address builds of a g++ library are three files,
    each built with its own flags; building one leaves the others."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    plain = native_build.build_all(["wire_codec"], san="")["wire_codec"]
    tsan = native_build.build_all(["wire_codec"], san="thread")["wire_codec"]
    asan = native_build.build_all(["wire_codec"], san="address")["wire_codec"]
    assert len({plain, tsan, asan}) == 3
    assert tsan.name.endswith("-tsan.so") and asan.name.endswith("-asan.so")
    assert not plain.name.endswith(("-tsan.so", "-asan.so"))
    assert plain.exists() and tsan.exists() and asan.exists()
    assert native_build.build_all(["wire_codec"], san="")["wire_codec"] == plain
    flags = native_build._gxx_flags("thread")
    assert "-O2" not in flags and {"-O1", "-g", "-fno-omit-frame-pointer",
                                   "-fsanitize=thread"} <= set(flags)
    assert native_build._gxx_flags("") == native_build.GXX_FLAGS
    # The variable picks the build when no mode is given.
    monkeypatch.setenv("GUBER_NATIVE_SAN", "asan")
    assert native_build.build_all(["wire_codec"])["wire_codec"] == asan


def test_cuda_libraries_ignore_the_sanitizer(monkeypatch, tmp_path):
    """A `.cu` library builds with the same command and under the same name
    whatever the sanitizer (a stand-in compiler records the command)."""
    log = tmp_path / "args.txt"
    fake = tmp_path / "fakecc"
    fake.write_text('#!/bin/sh\necho "$@" >> "%s"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n' % log)
    fake.chmod(0o755)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "nvcc_path", lambda: str(fake))
    for name in native_build.SOURCES:
        if native_build._is_cuda(name):
            assert native_build._target(name, "thread") == native_build._target(name)
            assert native_build._target(name, "address") == native_build._target(name)
    monkeypatch.setenv("GUBER_NATIVE_SAN", "thread")
    built = native_build.build_all(["fused_step", "sketch"])
    assert built == {n: native_build._target(n) for n in ("fused_step", "sketch")}
    lines = log.read_text().splitlines()
    assert len(lines) == 2 and not any("sanitize" in ln for ln in lines)
    assert all(" ".join(native_build.NVCC_FLAGS) in ln for ln in lines)


def test_load_refuses_a_sanitized_library_in_process(monkeypatch):
    """This process has no sanitizer runtime preloaded: with
    GUBER_NATIVE_SAN set, every g++ library is refused with an error that
    names LD_PRELOAD (no dlopen, no crash), and once unset it loads."""
    for mode in ("thread", "address"):
        monkeypatch.setenv("GUBER_NATIVE_SAN", mode)
        for name in cs.SAN_HOST_LIBS:
            with pytest.raises(RuntimeError, match="LD_PRELOAD"):
                native_build.load(name)
        with pytest.raises(RuntimeError, match="LD_PRELOAD"):
            wire_codec.decode_reqs(b"\x0a\x00", 1000, COLUMNAR_DISQUALIFIERS)
        with pytest.raises(RuntimeError, match="LD_PRELOAD"):
            native_plane.NativeDecisionPlane()
    monkeypatch.delenv("GUBER_NATIVE_SAN")
    assert native_build.load("wire_codec") is not None


def _ref_decode(body):
    return ref_codec.decode_reqs(body, 1000, REF_DISQUALIFIERS)


def _expected(bodies):
    """The reference front's answers and the reference codec's and plane's
    decodes of `bodies`."""
    return cs.san_expected(bodies, ref_h2.load(), ref_plane, ref_h2._CALLBACK, REF_DISQUALIFIERS,
                           _ref_decode)


def test_malformed_bodies_answer_as_the_reference():
    """Truncated varints, lengths past the end, counts far past the body,
    empty and huge keys, bad wire types and seeded random bytes: the port's
    codec and plane decode each as the reference's do, and the port's
    front (plain library) answers each as the reference's front does."""
    bodies = cs.malformed_bodies(cs.SEED)
    want_answers, want_decoded = _expected(bodies)
    got_answers, got_decoded = cs.san_expected(
        bodies, h2_fast.load(), native_plane, native_build.WINDOW_CALLBACK,
        COLUMNAR_DISQUALIFIERS, lambda b: wire_codec.decode_reqs(b, 1000, COLUMNAR_DISQUALIFIERS))
    assert got_decoded == want_decoded
    assert got_answers == want_answers
    assert {a[0] for a in want_answers} == {0, 13}  # both the OK and the INTERNAL answers
    assert sum(d["codec"] is None for d in want_decoded) > len(bodies) // 2


def test_a_claim_on_a_recycled_window_is_served(monkeypatch, tmp_path):
    """ROADMAP C5: a producer that loads the feeder's open index, then (after
    the serve thread rotated past that window, served and recycled it)
    claims rows in it, must still get its rows served without a flush.
    The race is widened in a copy of the sources: a 2 ms sleep between the
    producer's two loads.  Three Python producers pack 100 one-row RPCs
    each; every row is served within 2 s, with no flush."""
    anchor = "    CfWindow& w = f->slots[idx];\n    uint64_t cur = w.cursor.load();\n"
    for name in native_build.SOURCES["h2_server"]:
        src = (native_build.CSRC / name).read_text()
        if name == "columnar_feeder.cpp":
            assert src.count(anchor) == 1
            src = src.replace(anchor, anchor.replace(
                "    uint64_t cur", "    std::this_thread::sleep_for(std::chrono::milliseconds(2));"
                "\n    uint64_t cur"))
        (tmp_path / name).write_text(src)
    monkeypatch.setattr(native_build, "CSRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_libs", {})
    body = cs.encode_get_rate_limits([cs.san_item("san", "k")])
    for trial in range(3):
        feeder = native_plane.NativeColumnarFeeder(
            n_slots=3, max_rows=256, max_rpcs=64, flush_rows=8, window_s=0.0005,
            window_handler=cs.SanFront._feeder_window)
        packed = [0] * 3

        def lane(t):
            for _ in range(100):
                packed[t] += max(0, feeder.pack(body))

        threads = [threading.Thread(target=lane, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        deadline = time.monotonic() + 2.0
        while (feeder.stats()["feeder_served_rows"] < sum(packed)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        st = feeder.stats()
        feeder.close()
        assert sum(packed) > 0
        assert st["feeder_served_rows"] == st["feeder_rows"] == sum(packed), (trial, st)


def _require(mode):
    if native_build.sanitizer_preload(mode) is None:
        pytest.skip(f"no {cs.SAN_REPORT[mode]} runtime in this toolchain")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["thread", "address"])
@pytest.mark.parametrize("stress", cs.SAN_STRESSES)
def test_host_stress_under_sanitizer(mode, stress):
    """One stress in a sanitized child: no report, rc 0, its "ok" line
    (row and admission conservation, serial-equals-threaded schedules,
    every feeder row served), and every RPC of the load answered."""
    _require(mode)
    res = cs.san_host_stress(mode, stress, 4.0)
    assert not cs.san_host_failures(res), "\n".join(cs.san_host_failures(res))


@pytest.mark.slow
def test_malformed_bodies_under_asan():
    """The malformed bodies through the codec, the plane and the front of
    an AddressSanitizer child: no report, and every decode and answer
    equal to the reference's."""
    _require("address")
    bodies = cs.malformed_bodies(cs.SEED)
    answers, decoded = _expected(bodies)
    res = cs.san_host_stress("address", "malformed", 3.0, bodies=bodies)
    failures = cs.san_host_failures(res) + cs.san_malformed_failures(res, answers, decoded)
    assert not failures, "\n".join(failures)
    assert np.array_equal([a[0] for a in res["answers"]], [a[0] for a in answers])
