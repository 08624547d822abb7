"""The port's operator surface on the CPU: the CLI dispatcher, the
BS-in-a-box app (``amps_tpu_torch.apps.bs_app``) against the JAX app, the
RECC capture monitor across the two packages, and both examples."""

import re

import numpy as np
import pytest
import torch

from amps_tpu_torch.__main__ import main as cli
from amps_tpu_torch.apps import bs_app, recc_monitor

torch.set_num_threads(2)

ORIGINATION = "origination:5551234567:5551230000"


def _station_lines(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("[station]")]


def test_cli_dispatcher_codes(capsys):
    assert cli(["help"]) == 0
    assert "python -m amps_tpu_torch bs" in capsys.readouterr().out
    assert cli(["nonsense"]) == 2
    capsys.readouterr()
    assert cli(["bench"]) == 2
    assert "no benchmark yet" in capsys.readouterr().err


def test_bs_station_lines_match_jax(tmp_path, capsys):
    """One superframe with a simulated origination: the port's app prints
    the JAX app's [station] lines, and both TX files hold one superframe
    of the same length."""
    from apps import bs_app as jbs_app
    common = ["--channels", "8", "--superframes", "1", "--no-server",
              "--simulate", ORIGINATION]
    tout, jout = tmp_path / "t.f32", tmp_path / "j.f32"
    assert cli(["bs", *common, "--device", "cpu",
                "--tx-out", str(tout)]) is None
    port = _station_lines(capsys.readouterr().out)
    jbs_app.main([*common, "--platform", "cpu", "--tx-out", str(jout)])
    jax = _station_lines(capsys.readouterr().out)
    assert port == jax
    assert "[station] command: page 5551230000" in port
    assert tout.stat().st_size > 0
    assert tout.stat().st_size == jout.stat().st_size == 50004 * 4 * 8


def test_bs_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bs_app.main(["--channels", "8", "--superframes", "1",
                     "--no-server"])


def test_bs_mesh_exits_naming_m7(capsys):
    """``bs --mesh`` runs the multi-device station (it once exited naming
    ROADMAP M7): two blocks of a 2x2 mesh on CPU workers."""
    assert cli(["bs", "--mesh", "2x2", "--channels", "8", "--device", "cpu",
                "--no-server", "--blocks", "2"]) is None
    out = capsys.readouterr().out
    assert "M7" not in out
    assert "[bs] block 1: tx 200016 samples" in out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_app(package, args, page=False):
    """One run of the mesh app of either package; with ``page`` the app
    serves commands and an operator pages 5551234567 through the socket
    once the server is up.  The port's app binds ``--port 0`` and
    reports the port it bound; the JAX app is given a free port."""
    import socket
    import threading
    import time
    from apps import bs_app as jbs_app
    result = {}
    if package == "port":
        argv = ["--mesh", "2x2", "--channels", "8", "--device", "cpu", *args]
        main = bs_app.main
    else:
        argv = ["--mesh", "2x2", "--channels", "8", "--platform", "cpu",
                *args]
        main = jbs_app.main
    if not page:
        main(argv + ["--no-server"], result)
        return result
    given = 0 if package == "port" else _free_port()
    th = threading.Thread(target=main,
                          args=(argv + ["--port", str(given)], result),
                          daemon=True)
    th.start()
    deadline = time.time() + 300
    sock = None
    while time.time() < deadline and sock is None and th.is_alive():
        port = result.get("port", given)
        try:
            if port:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=1)
        except OSError:
            pass
        if sock is None:
            time.sleep(0.2)
    assert sock is not None, "command server never came up"
    sock.sendall(b"page 5551234567\n")
    time.sleep(0.2)
    sock.close()
    th.join(timeout=600)
    assert not th.is_alive(), "mesh station did not finish"
    return result


def _events(station):
    return [(e.kind, str(e.payload)) for e in station.events]


SUP_ARGS = ["--voice-slot-map", "355:4,356:5", "--sup-timers", "3.0:0.8"]
MESH_SCENARIOS = {
    "origination": (["--simulate", "mobile:5551234567:originate:7025551000",
                     *SUP_ARGS, "--blocks", "30"],
                    ["originate 7025551000", "assigned 355", "hang_up"]),
    "two_calls": (["--simulate", "mobile:5551234567:originate:7025551000:2:3",
                   "--simulate", "mobile:4155559876:originate:7025552000:5:6",
                   *SUP_ARGS, "--blocks", "40"],
                  ["originate 7025551000", "assigned 355", "hang_up"]),
    "registration": (["--simulate", "mobile:2135551212:register:2",
                      "--blocks", "6"], ["register", "audit_confirmed"]),
}


@pytest.mark.parametrize("name", sorted(MESH_SCENARIOS))
def test_mesh_station_matches_jax(name):
    """tests/test_apps.py's mesh scenarios through both apps (2x2, M=8):
    the port's station log, its supervision timeline and each mobile's
    log equal the JAX app's."""
    args, first_log = MESH_SCENARIOS[name]
    got, want = _mesh_app("port", args), _mesh_app("jax", args)
    assert got["timeline"] == want["timeline"]
    assert [m.log for m in got["mobs"]] == [m.log for m in want["mobs"]]
    assert got["mobs"][0].log == first_log
    assert _events(got["station"]) == _events(want["station"])
    assert not got["station"].supervisors
    if name == "two_calls":
        rels = [e.payload.channel for e in got["station"].events
                if e.kind == "supervision_event"
                and e.payload.kind == "release"]
        assert rels == [355, 356]
    if name != "registration":
        assert any(k == "release" for k, _ in got["timeline"])


def test_mesh_station_paged_through_the_socket_matches_jax():
    """The operator pages through the command server of each app; the
    mobile answers over the sharded RX, SAT/ST through the sharded
    analysis drive the call to its ST release: the same supervision
    timeline and mobile log as the JAX app."""
    args = ["--simulate", "mobile:5551234567", *SUP_ARGS, "--blocks", "30"]
    got = _mesh_app("port", args, page=True)
    want = _mesh_app("jax", args, page=True)
    assert got["mob"].log[:4] == ["paged", "assigned 355", "ringing",
                                  "answered"]
    assert got["mob"].log == want["mob"].log
    assert got["timeline"] == want["timeline"]
    kinds = [k for _, k in got["timeline"]]
    assert "answer" in kinds and "release" in kinds
    assert any(e.kind == "debug" and "paging" in str(e.payload)
               for e in got["station"].events)
    assert not got["station"].supervisors


def test_bs_voice_slots_and_two_mobiles():
    """The app as the card runs it, at M=8: voice slots 4-5 under
    supervision, an origination and a registration on slot 3.  Each burst
    is reported once with words A and B good; the station pages the
    dialed number and answers the registration; the TX thread made two
    superframes."""
    result = {}
    bs_app.main(["--channels", "8", "--superframes", "2", "--no-server",
                 "--device", "cpu", "--voice-slot-map", "355:4,356:5",
                 "--simulate", ORIGINATION,
                 "--simulate", "registration:7735550000:0x77"], result)
    reps, st, stats = result["reports"], result["station"], result["stats"]
    assert [r.channel for r in reps] == [3, 3]
    assert all(r.word_ok[:2].all() for r in reps)
    cmds = [str(e.payload) for e in st.events if e.kind == "command"]
    assert "page 5551230000" in cmds
    assert any(e.kind == "debug" and "registration" in str(e.payload)
               for e in st.events)
    assert len([e for e in st.events if e.kind == "focc_words"]) >= 2
    assert stats.tx_blocks == 2 and stats.tx_samples == 2 * 50004 * 4
    assert stats.rx_blocks == 2 and stats.rx_samples == 2 * 16384 * 4
    assert len(result["tx_block_s"]) == 2 and len(result["rx_block_s"]) == 2
    assert result["tx_meter"].total >= stats.tx_samples


def test_bs_rx_file_and_command_server(tmp_path, capsys):
    """--rx-in replays a capture file through the receiver, and the
    command server binds the free port it is given as 0."""
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    band = synthesize_reverse_band(
        [MobileEvent("page_response", 5, 3000, "7735550000")],
        MultichannelSpec(num_channels=8), 40000, device="cpu")
    cap = tmp_path / "cap.f32"
    band.numpy().tofile(cap)
    result = {}
    bs_app.main(["--channels", "8", "--superframes", "1", "--port", "0",
                 "--device", "cpu", "--rx-in", str(cap)], result)
    out = capsys.readouterr().out
    port = int(re.search(r"command server on 127\.0\.0\.1:(\d+)",
                         out).group(1))
    assert port > 0
    assert [r.channel for r in result["reports"]] == [5]
    assert result["stats"].rx_samples == 40000 * 4
    assert "[station] debug: got a response from MIN=7735550000" in out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_capture_replay_roundtrip(tmp_path, writer, reader):
    from apps import recc_monitor as jmon
    path = str(tmp_path / "cap.f32")
    events = ["page_response:5551234567"]
    if writer == "jax":
        n = jmon.synthesize_capture(path, events)
    else:
        n = recc_monitor.synthesize_capture(path, events, device="cpu")
    assert n > 0
    if reader == "jax":
        found = jmon.monitor(path)
    else:
        found = recc_monitor.monitor(path, device="cpu")
    assert found == 1


def test_monitor_cli_self_test(tmp_path, capsys):
    path = str(tmp_path / "cap.f32")
    assert cli(["monitor", "--device", "cpu", "--synthesize",
                "registration:7735550000:0x77", path]) == 0
    out = capsys.readouterr().out
    assert "1 burst(s) decoded" in out and "MIN=7735550000" in out


def test_bs_loopback_demo():
    from amps_tpu_torch.examples import bs_loopback_demo
    assert bs_loopback_demo.main(device="cpu") == 0


def test_call_lifecycle_demo():
    from amps_tpu_torch.examples import call_lifecycle_demo
    log = call_lifecycle_demo.main(device="cpu")
    assert log[:4] == ["paged", "assigned 355", "ringing", "answered"]
    assert "hang_up" in log


def test_capture_synthesis_matches_jax(tmp_path):
    """The port's synthetic capture is the JAX capture to f32 rounding."""
    from apps import recc_monitor as jmon
    a, b = str(tmp_path / "a.f32"), str(tmp_path / "b.f32")
    ev = [ORIGINATION]
    assert jmon.synthesize_capture(a, ev) == \
        recc_monitor.synthesize_capture(b, ev, device="cpu")
    assert np.abs(np.fromfile(a, np.float32)
                  - np.fromfile(b, np.float32)).max() < 1e-4


def test_bs_sections_show_in_a_profiler_window():
    """The app's TX and RX thread steps are utils.profiling.trace ranges,
    so a torch.profiler window that records every thread (as
    chip_smoke's profile_window does) names them."""
    all_threads = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=all_threads) as prof:
        bs_app.main(["--channels", "8", "--superframes", "1", "--no-server",
                     "--device", "cpu", "--simulate", ORIGINATION])
    names = [e.name for e in prof.events()]
    assert names.count("bs_app.tx_superframe") == 1
    assert names.count("bs_app.rx_block") == 1
