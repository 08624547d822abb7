"""The port's kernels as the benchmark counts and bounds them.

Each wrapper that a cell's loop or receiver calls is one ``Kernel``: the
pattern of the CUDA kernels that one of its calls runs on the path its
width takes, how many it launches, and the least time of the call.

* K2 (``kernels.rx_front.analyze_demod``) and K4
  (``kernels.synth.synthesize_block``) take the FFT tile at every width
  it holds and the device-memory route elsewhere
  (``kernels.analysis.route_length(M) > 0``).  On the tile K2 is one
  ``rx_front_kernel``; K4 is ``chunk_launches(T)`` ``synth_kernel``
  launches, and past ``CHUNK_TAPS`` taps one ``synth_combine_kernel``
  more.  On the route each call is ``route.launches(M, Nh, behind)``
  ``route_*`` kernels (behind 1 for K2, 0 for K4); ``route_pass_kernel``
  serves both, so the two share one pattern.
* K5 (``kernels.trigger_search.search``) is one
  ``trigger_search_kernel`` whatever its row.

A call's least time is the same work on every path: the bank pass by M
(``roofline.bank_bound_s``) for K2 and K4, the search by its rows
(``roofline.search_bound_s``) for K5.  A wrapper's ``LAUNCHES`` counts
``step`` a call: K4 on the tile counts each of its chunks, every other
wrapper and path one a call.  ``trace.profile`` holds each pattern's
spans to the calls the counters saw times the kernels a call launches,
and the readers divide the calls' least time by the device time of the
pattern's kernels.
"""

from __future__ import annotations

import dataclasses
import importlib

from portbench import roofline

TILE = {"k2": r"\brx_front_kernel",
        "k4": r"\b(synth_kernel|synth_combine_kernel)"}
ROUTE = r"\broute_"
SEARCH = r"\btrigger_search_kernel"


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One wrapper of the port on the path a cell's width takes."""
    name: str            # "k2", "k4", "k5"
    path: str            # "tile", "route" or "search"
    pattern: str         # regex of the CUDA kernels of one call
    launches: int        # CUDA kernels one call launches
    bound_s: float       # least seconds of one call
    module: str          # the wrapper's module under amps_tpu_torch.kernels
    step: int = 1        # its module's LAUNCHES a call

    def calls(self) -> int:
        """The wrapper's calls so far, from its module's ``LAUNCHES``."""
        mod = importlib.import_module(f"amps_tpu_torch.kernels.{self.module}")
        return mod.LAUNCHES // self.step


def bank(M: int, T: int, Nh: int):
    """(K2, K4) of a call over Nh hops at width M with T taps a phase."""
    from amps_tpu_torch.kernels import route
    from amps_tpu_torch.kernels.analysis import CHUNK_TAPS, route_length
    from amps_tpu_torch.kernels.synth import chunk_launches
    b2 = roofline.bank_bound_s(M, T, Nh, roofline.rx_front_bytes(M, T, Nh))
    b4 = roofline.bank_bound_s(M, T, Nh, roofline.synth_bytes(M, T, Nh))
    if route_length(M):
        return (Kernel("k2", "route", ROUTE, route.launches(M, Nh, 1), b2,
                       "rx_front"),
                Kernel("k4", "route", ROUTE, route.launches(M, Nh, 0), b4,
                       "synth"))
    chunks = chunk_launches(T)
    return (Kernel("k2", "tile", TILE["k2"], 1, b2, "rx_front"),
            Kernel("k4", "tile", TILE["k4"], chunks + (T > CHUNK_TAPS), b4,
                   "synth", chunks))


def search(M: int, sps: int, nsym: int, K: int) -> Kernel:
    """K5 over M rows of ``sps`` phase streams of ``nsym`` symbols with K
    picks."""
    return Kernel("k5", "search", SEARCH, 1,
                  roofline.search_bound_s(M, sps, nsym, K), "trigger_search")


def search_symbols(hops: int, sps: int) -> int:
    """Symbols of a phase stream of a demod window of ``hops`` samples
    (``rx.correlator.symbol_phase_streams``)."""
    return (hops - (sps - 1)) // sps


def loop(spec, frames: int, max_bursts: int):
    """[K4, K2, K5] of one block of the closed loop
    (``runtime.streamer.closed_loop_block``): the block's hops through
    K4 and K2, the carried overlap and the block's hops through K5."""
    from amps_tpu_torch.runtime.streamer import closed_loop_geometry
    M, T, sps = spec.num_channels, spec.taps_per_phase, spec.chan_sps
    n_hops, _, carry_hops = closed_loop_geometry(spec, frames)
    k2, k4 = bank(M, T, n_hops)
    return [k4, k2, search(M, sps, search_symbols(carry_hops + n_hops, sps),
                           max_bursts)]


def receiver(spec, push_hops: int, ovr: int, max_bursts: int):
    """[K2, K5] of one push of ``push_hops`` hops into
    ``MultichannelReceiver``, whose carried overlap is ``ovr`` hops."""
    M, T, sps = spec.num_channels, spec.taps_per_phase, spec.chan_sps
    return [bank(M, T, push_hops)[0],
            search(M, sps, search_symbols(ovr + push_hops, sps), max_bursts)]
