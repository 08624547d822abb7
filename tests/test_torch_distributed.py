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

A job starts through ``distributed.launch``: process 0 binds the store's
port and reports it, then process 1 starts.  It ends through
``distributed.shutdown``.  The delayed cases hold the job's rendezvous
and its shutdown with rank 1 late: the store's server, process 0, must
stay up until rank 1 is done with it.
"""

import pathlib
import re
import sys

import pytest
import torch

from amps_tpu_torch.parallel import distributed as D
from amps_tpu_torch.parallel.distributed import choose_backend

# how long rank 1 is held back in the delayed cases, seconds
DELAY_S = 2.0

_WORKER = r'''
import sys
import time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from amps_tpu_torch.parallel import distributed as dist
from amps_tpu_torch.parallel import halo

pid = int(sys.argv[1])
delay = {delay!r} if pid == 1 else 0
dist.initialize(sys.argv[2], 2, pid, backend={backend!r})
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
time.sleep(delay)      # rank 1 late for the step's last collective
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

if delay:
    # rank 1 late to check out after its group is gone
    destroy = torch.distributed.destroy_process_group

    def late_destroy():
        destroy()
        print("DESTROYED", pid, time.monotonic(), flush=True)
        time.sleep(delay)
    torch.distributed.destroy_process_group = late_destroy
dist.shutdown()
print("LEFT", pid, time.monotonic(), flush=True)
'''


def run_two_processes(script, timeout=180):
    """Run ``script`` (a path) as processes 0 and 1 of one job, each with
    a timeout of its own (``distributed.launch``: process 0 binds the
    job's port, then process 1 starts with it); returns their outputs,
    or fails with the output of a process that failed."""
    done = D.launch(lambda pid, address: [sys.executable, str(script),
                                          str(pid), address],
                    timeout=timeout)
    for code, out in done:
        assert code == 0, out[-3000:]
    return [out for _, out in done]


def step_worker(tmp_path, device="cpu", M=8, T=4, backend=None, delay=0):
    """The two-process halo, psum and sharded-step worker as a script;
    ``delay`` seconds hold rank 1 back before the step's last collective
    and again between its ``destroy_process_group`` and its check-out."""
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo, device=device, M=M, T=T,
                                     backend=backend, delay=delay))
    return script


def check_step_outputs(outs, backend="gloo"):
    # the JAX worker's sum: 2016 + the halos 42 and 90
    for pid, out in enumerate(outs):
        assert f"BACKEND {pid} {backend}" in out, out[-3000:]
        assert f"PSUM {pid} 2148.0" in out, out[-3000:]
        # 2 * 12480 RX hops and 50004 TX hops: both parities even
        assert f"STEPOK {pid} 0 0" in out, out[-3000:]
        assert f"LEFT {pid} " in out, out[-3000:]


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_two_process_gloo_mesh_halo_psum_and_step(tmp_path, backend):
    """On the CPU ``initialize`` picks gloo, and gloo asked for runs the
    same."""
    check_step_outputs(run_two_processes(step_worker(tmp_path,
                                                     backend=backend)))


def _stamp(out, word, pid):
    return float(re.search(rf"^{word} {pid} (\S+)$", out, re.M).group(1))


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_two_process_step_with_rank_1_delayed(tmp_path, backend):
    """Rank 1 comes late to the step's last collective and, after its
    process group is gone, late to check out: both processes exit 0 with
    the step's results, and process 0, the store's server, leaves only
    after rank 1 has checked out."""
    outs = run_two_processes(step_worker(tmp_path, backend=backend,
                                         delay=DELAY_S))
    check_step_outputs(outs, backend=backend or "gloo")
    assert _stamp(outs[0], "LEFT", 0) >= (_stamp(outs[1], "DESTROYED", 1)
                                          + DELAY_S), outs


_CHOICE = r'''
import sys
import time
sys.path.insert(0, {repo!r})
import torch.distributed
from amps_tpu_torch.parallel import distributed as dist

pid = int(sys.argv[1])
delay = {delay!r} if pid == 1 else 0


class LateReads(torch.distributed.Store):
    """The job's store, with the first read after a write ``delay``
    seconds late."""

    def __init__(self, store):
        super().__init__()
        self._store, self._late = store, False

    def set(self, key, value):
        self._store.set(key, value)
        self._late = True

    def get(self, key):
        if self._late:
            time.sleep(delay)
            self._late = False
        return self._store.get(key)

    def wait(self, keys, *timeout):
        return self._store.wait(keys, *timeout)


if delay:
    tcp_store = torch.distributed.TCPStore
    torch.distributed.TCPStore = lambda *a, **k: LateReads(
        tcp_store(*a, **k))
# both processes report the same card, as two processes on one H100 do
dist._card = lambda: "NVIDIA H100 80GB HBM3 GPU-0a1b"
try:
    dist.initialize(sys.argv[2], 2, pid, backend="nccl")
except ValueError as e:
    print("REFUSED", pid, e, flush=True)
else:
    raise SystemExit("NCCL was not refused")
dist.shutdown()
'''


def check_refused(tmp_path, delay):
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "choice.py"
    script.write_text(_CHOICE.format(repo=repo, delay=delay))
    for pid, out in enumerate(run_two_processes(script, timeout=60)):
        assert (f"REFUSED {pid} NCCL takes one process a card: ranks [0, 1] "
                f"share card NVIDIA H100 80GB HBM3 GPU-0a1b") in out, out


def test_nccl_refused_when_two_processes_share_a_card(tmp_path):
    """Asked for NCCL while both processes of the job hold one card, both
    raise ValueError naming the card (decided from the cards gathered
    over the job's store, before NCCL is reached)."""
    check_refused(tmp_path, 0)


def test_nccl_refused_with_rank_1_late_to_read_the_cards(tmp_path):
    """Rank 1 reads the cards ``DELAY_S`` after it wrote its own: process
    0, which serves the store and has read both cards at once, waits for
    rank 1 to check in before either refuses, so both print REFUSED and
    exit 0 (without the rendezvous process 0 left first and rank 1 lost
    the store)."""
    check_refused(tmp_path, DELAY_S)


def test_shutdown_without_a_job_and_twice(capsys):
    """``shutdown`` does nothing before ``initialize`` and nothing the
    second time; a one-process job on port 0 binds a free port, reports
    it, runs gloo and is gone after ``shutdown``."""
    assert not torch.distributed.is_initialized()
    D.shutdown()
    D.shutdown()
    D.initialize("127.0.0.1:0", 1, 0, backend="gloo")
    try:
        assert D.backend() == "gloo" and D.process_count() == 1
        port = int(re.search(rf"^{D.COORDINATOR_LINE}127\.0\.0\.1:(\d+)$",
                             capsys.readouterr().out, re.M).group(1))
        assert port > 0
    finally:
        D.shutdown()
    assert not torch.distributed.is_initialized() and D.backend() is None
    D.shutdown()


@pytest.mark.parametrize("address,pid", [("127.0.0.1:0", 1),
                                         ("tcp://127.0.0.1", 0)])
def test_initialize_refuses_an_address_without_the_port(address, pid):
    """Port 0, a free port, is for process 0 alone: process 1 must be
    given the port process 0 bound; an address without a port is
    refused."""
    with pytest.raises(ValueError, match="port 0, a free one, is for "
                                         "process 0 alone"):
        D.initialize(address, 2, pid)
    assert not torch.distributed.is_initialized()


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
