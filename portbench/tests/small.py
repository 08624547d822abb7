"""Cells for the CPU tests: the benchmark's, and the receiver's cells
kept out of BENCHMARK.json until the port's receiver is mended
(``rx_cell``), cut to a size the CPU tests hold: 64 channels; a stream
of pushes of 2048 hops with one burst a pool on each of 6 control
channels, or a loop of 4 blocks a call with taps of 16 channels and 64
hops; every other setting the cell's own."""

import json

from portbench import run

M = 64
RX_CELLS = {"band1024.rx": "band1024", "wide16384.rx": "wide16384"}


def rx_cell(name: str) -> dict:
    """A receiver cell at its full size, found as ``run.load_cell``
    finds a cell: its configuration, the ``rx_stream`` mix and its
    limits."""
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cfg = RX_CELLS[name]
    cell = {"name": name, "config": cfg, "traffic": "rx_stream", "chips": 1}
    here = run.HERE
    return dict(bench=bench, cell=cell,
                cfg=json.loads((here / "configs" / f"{cfg}.json").read_text()),
                mix=json.loads((here / "traffic" / "rx_stream.json")
                               .read_text()),
                limits=json.loads((here / "limits" / f"{name}.json")
                                  .read_text()))


def small(cell: str = "band1024.rx") -> dict:
    found = rx_cell(cell) if cell in RX_CELLS else run.load_cell(cell)
    found["cfg"] = dict(found["cfg"], num_channels=M,
                        sample_rate_hz=M * found["cfg"]["channel_spacing_hz"],
                        recc_channels=[350, 355], center_channel=383)
    if found["mix"]["kind"] == "rx_stream":
        found["mix"] = dict(found["mix"], push_hops=2048,
                            bursts_per_channel=1)
    else:
        found["mix"] = dict(found["mix"], nblocks=4, tap_channels=16,
                            tap_hops=64)
    return found
