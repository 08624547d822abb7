"""The port's multi-process mesh on the CPU: two processes joined by
``torch.distributed`` over gloo form the global mesh {time: 2, chan: 2}
(``amps_tpu_torch.parallel.distributed``), one time row each.

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

_WORKER = r'''
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from amps_tpu_torch.parallel import distributed as dist
from amps_tpu_torch.parallel import halo

pid = int(sys.argv[1])
dist.initialize("127.0.0.1:" + sys.argv[2], 2, pid)
assert dist.process_count() == 2
mesh = dist.global_mesh(devices=["cpu", "cpu"])
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

spec = MultichannelSpec(num_channels=8, taps_per_phase=4, fold="bank")
M, sps, P = 8, spec.chan_sps, 4
hal = full_demod_halo(spec)
row_hops = 12480
events = [MobileEvent("origination", 1, 700, "5551234567", "7025551000",
                      esn=777),
          # crosses hop 12480: the time-row and process boundary
          MobileEvent("page_response", 2, row_hops - 5000, "4155559876")]
xr = synthesize_reverse_band(events, spec, 2 * row_hops, noise_sigma=0.001,
                             device="cpu")
n_hops = 18 * 463 * 2 * sps
src = np.random.default_rng(99).normal(0, 0.3, (n_hops, 2)).astype(
    np.float32)
tx = MultichannelTransmitter(spec, control_channels=[1], device="cpu")
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
out, st = step(wp, sharded_stream_state(spec, hal, "cpu"), mode, src_all, xr)
share = n_hops // 2 * P
want = single[pid * share:(pid + 1) * share]
err = float((out["tx_wideband"] - want).abs().max())
assert err <= 2e-5 * max(float(want.abs().max()), 1.0), err
found = []
o = {{k: v.numpy() for k, v in out.items()}}
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
assert torch.equal(st["hist"], xr[xr.shape[0] - (M * 4 - P):])
print("STEPOK", pid, st["parity"], st["tx_parity"], flush=True)
'''


def test_two_process_gloo_mesh_halo_psum_and_step(tmp_path):
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    # the JAX worker's sum: 2016 + the halos 42 and 90
    for pid, out in enumerate(outs):
        assert f"PSUM {pid} 2148.0" in out, out[-3000:]
        # 2 * 12480 RX hops and 50004 TX hops: both parities even
        assert f"STEPOK {pid} 0 0" in out, out[-3000:]
