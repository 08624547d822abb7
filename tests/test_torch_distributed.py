"""The port's multi-process mesh on the CPU: two processes joined by
``torch.distributed`` over gloo form the global mesh {time: 2, chan: 2}
(``amps_tpu_torch.parallel.distributed``), one time row each.  The
backend is gloo whether ``initialize`` chooses it (no card) or is asked
for it; NCCL asked for where two processes share a card raises.

The halo exchange along ``time`` and the psum cross the process
boundary and give each rank the sum the JAX package's two-process test
(tests/test_distributed.py) prints.  Then the sharded full-duplex step
runs across the two processes: the synthesis overlap-add tail and the
analysis halo go point-to-point, the carried tails are broadcast from the
last process, and a burst that spans the process boundary decodes
bit-exactly; each process's share of the TX wideband equals the
single-device transmitter's.  Each subprocess has a timeout of its own.
"""

import pathlib
import socket
import subprocess
import sys

import pytest

from amps_tpu_torch.parallel.distributed import choose_backend

_WORKER = r'''
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from amps_tpu_torch.parallel import distributed as dist
from amps_tpu_torch.parallel import halo

pid = int(sys.argv[1])
dist.initialize("127.0.0.1:" + sys.argv[2], 2, pid, backend={backend!r})
assert dist.process_count() == 2
print("BACKEND", pid, dist.backend(), flush=True)
dev = torch.device({device!r})
mesh = dist.global_mesh(devices=[dev, dev])
assert mesh.shape == {{"time": 2, "chan": 2}} and mesh.rows == 1
assert dist.is_coordinator() == (pid == 0)

# x = arange(64).reshape(2, 32); worker (t, c) holds x[t, 16c:16c+16];
# the time-1 workers gain their time-0 neighbour's last 3 columns
n = 16
x = torch.arange(2 * n * 2, dtype=torch.float32).reshape(2, n * 2)
parts = [x[t:t + 1, c * n:(c + 1) * n]
         for _, t, c in (mesh.worker(i) for i in range(2))]
xe = halo.halo_exchange_left(mesh, parts, 3, "time", sample_axis=1)
s = halo.psum(mesh, [e.sum() for e in xe], halo.RING)
print("PSUM", pid, float(s[0]), flush=True)

# the sharded full-duplex step across the two processes
from amps_tpu_torch.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu_torch.parallel.pipeline import (MultichannelSpec,
    TX_FOCC, TX_SOURCE, full_demod_halo, make_sharded_bs_stream_step,
    sharded_stream_state)
from amps_tpu_torch.runtime.streamer import MultichannelTransmitter
from amps_tpu_torch.rx import correlator
from amps_tpu_torch.tx.focc import FoccStream

M, T = {M}, {T}
spec = MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
sps, P = spec.chan_sps, M // 2
hal = full_demod_halo(spec)
row_hops = 12480
events = [MobileEvent("origination", 1, 700, "5551234567", "7025551000",
                      esn=777),
          # crosses hop 12480: the time-row and process boundary
          MobileEvent("page_response", 2, row_hops - 5000, "4155559876")]
xr = synthesize_reverse_band(events, spec, 2 * row_hops, noise_sigma=0.001,
                             device=dev)
n_hops = 18 * 463 * 2 * sps
src = np.random.default_rng(99).normal(0, 0.3, (n_hops, 2)).astype(
    np.float32)
tx = MultichannelTransmitter(spec, control_channels=[1], device=dev)
tx.set_channel_source(4, lambda k: src)
single = tx.next_block()
pairs = FoccStream(sps=sps).next_word_pairs()
wp = np.broadcast_to(pairs, (M,) + pairs.shape).copy()
mode = np.zeros(M, np.int32)
mode[1], mode[4] = TX_FOCC, TX_SOURCE
src_all = np.zeros((n_hops, M, 2), np.float32)
src_all[:, 4] = src
step = make_sharded_bs_stream_step(mesh, spec, hal, max_bursts=2,
                                   rx_external=True, tx_sources=True)
out, st = step(wp, sharded_stream_state(spec, hal, dev), mode, src_all, xr)
share = n_hops // 2 * P
want = single[pid * share:(pid + 1) * share]
err = float((out["tx_wideband"] - want).abs().max())
assert err <= 2e-5 * max(float(want.abs().max()), 1.0), err
found = []
o = {{k: v.cpu().numpy() for k, v in out.items()}}
for c in range(M):
    for k in range(o["starts"].shape[2]):
        if o["valid"][0, c, k]:
            a = (mesh.row0 * row_hops - hal + int(o["starts"][0, c, k]))
            found.append((c, a, o["words"][0, c, k].tolist(),
                          bool(o["word_ok"][0, c, k][:2].all())))
every = [None, None]
torch.distributed.all_gather_object(every, found)
kept = {{}}
for c, a, w, ok in sorted(every[0] + every[1]):
    if c in kept and abs(a - kept[c][0]) < correlator.CAPTURE_SYMBOLS * sps // 2:
        continue
    kept[c] = (a, w, ok)
assert sorted(kept) == [1, 2], kept
for ev in events:
    a, w, ok = kept[ev.channel]
    want_w = np.stack(ev.words())
    assert ok and np.array_equal(np.asarray(w)[: len(want_w)], want_w)
a2 = kept[2][0]
assert a2 < row_hops < a2 + correlator.CAPTURE_SYMBOLS * sps, a2
# the carried tails came from the last process to both
assert torch.equal(st["hist"], xr[xr.shape[0] - (M * T - P):])
print("STEPOK", pid, st["parity"], st["tx_parity"], flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_processes(script, timeout=180):
    """Run ``script`` (a path) as processes 0 and 1 of one job, each with
    a timeout of its own; returns their outputs, or fails with the
    output of a process that failed."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def step_worker(tmp_path, device="cpu", M=8, T=4, backend=None):
    """The two-process halo, psum and sharded-step worker as a script."""
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo, device=device, M=M, T=T,
                                     backend=backend))
    return script


def check_step_outputs(outs, backend="gloo"):
    # the JAX worker's sum: 2016 + the halos 42 and 90
    for pid, out in enumerate(outs):
        assert f"BACKEND {pid} {backend}" in out, out[-3000:]
        assert f"PSUM {pid} 2148.0" in out, out[-3000:]
        # 2 * 12480 RX hops and 50004 TX hops: both parities even
        assert f"STEPOK {pid} 0 0" in out, out[-3000:]


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_two_process_gloo_mesh_halo_psum_and_step(tmp_path, backend):
    """On the CPU ``initialize`` picks gloo, and gloo asked for runs the
    same."""
    check_step_outputs(run_two_processes(step_worker(tmp_path,
                                                     backend=backend)))


_CHOICE = r'''
import sys
sys.path.insert(0, {repo!r})
from amps_tpu_torch.parallel import distributed as dist

pid = int(sys.argv[1])
# both processes report the same card, as two processes on one H100 do
dist._card = lambda: "NVIDIA H100 80GB HBM3 GPU-0a1b"
try:
    dist.initialize("127.0.0.1:" + sys.argv[2], 2, pid, backend="nccl")
except ValueError as e:
    print("REFUSED", pid, e, flush=True)
else:
    raise SystemExit("NCCL was not refused")
'''


def test_nccl_refused_when_two_processes_share_a_card(tmp_path):
    """Asked for NCCL while both processes of the job hold one card, both
    raise ValueError naming the card (decided from the cards gathered
    over the job's store, before NCCL is reached)."""
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "choice.py"
    script.write_text(_CHOICE.format(repo=repo))
    for pid, out in enumerate(run_two_processes(script, timeout=60)):
        assert (f"REFUSED {pid} NCCL takes one process a card: ranks [0, 1] "
                f"share card NVIDIA H100 80GB HBM3 GPU-0a1b") in out, out


@pytest.mark.parametrize("cards,asked,want", [
    (["A", "B"], None, "nccl"),          # a card a process
    (["A", "A"], None, "gloo"),          # two processes on one card
    ([None, None], None, "gloo"),        # the CPU
    (["A", None], None, "gloo"),
    (["A", "B", "C", "A"], None, "gloo"),
    (["A", "B"], "gloo", "gloo"),
    (["A", "A"], "gloo", "gloo"),
    (["A", "B"], "nccl", "nccl"),
])
def test_choose_backend(cards, asked, want):
    assert choose_backend(cards, asked) == want


@pytest.mark.parametrize("cards,asked,match", [
    (["A", "B", "A"], "nccl", r"ranks \[0, 2\] share card A"),
    ([None, "B"], "nccl", r"ranks \[0\] have none"),
    (["A", "B"], "mpi", "one of"),
])
def test_choose_backend_refuses(cards, asked, match):
    with pytest.raises(ValueError, match=match):
        choose_backend(cards, asked)
