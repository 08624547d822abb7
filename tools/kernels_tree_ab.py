"""Two source trees of the port, kernel against kernel, on one CUDA card.

Builds each tree's main kernel library (the powers of two) and its
libraries of the cluster widths 8192 (two blocks) and 16384 (four, the
radix-C pass), compares the SASS of every kernel
instantiation in the two (``cuobjdump -sass``, instruction text without
addresses and encodings, the first 4096 instructions of each function),
each function paired with the other tree's by
kernel and template arguments (``kernel_key``: not by its whole
signature, so a kernel whose parameters or default template argument
changed still pairs), then times each kernel's device time at M=1024
and 8192, Nh=8192, under torch.profiler -- and the synthesis kernel's
at M=1536 (its own library, built at first use) and 2048 too --, the
trees alternated six times, one process a turn.  Use it to show that a
change to the FFT tile leaves the kernels it does not mean to change as
they were.  Run from the repository root with a second tree unpacked
beside it (``git archive <commit> | tar -x -C DIR``):

    python3 tools/kernels_tree_ab.py OLD_TREE NEW_TREE
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
TURNS = 6

# one turn: every kernel 40 times at each of WIDTHS (a power of two of
# the main library and the cluster of two at 8192), and the synthesis at
# the SYNTH_WIDTHS, under the profiler; prints
# {kernel<M>: (mean device ms a launch, launches)}
_PROFILE = r'''
import sys, json, re
sys.path.insert(0, sys.argv[1])
WIDTHS = (1024, 8192)
SYNTH_WIDTHS = (1536, 2048)
import torch
from torch.profiler import profile, ProfilerActivity
from amps_tpu_torch.eval.traffic import unit_channel_band
from amps_tpu_torch.kernels import analysis as KA, rx_front as R
from amps_tpu_torch.kernels import rx_phases as K, synth as S
dev = torch.device("cuda", 0)
T, Nh = 8, 8192
fns = []
for M in WIDTHS:
    x = unit_channel_band(M, T, Nh, 1, dev)
    prev = torch.zeros((M, 2), device=dev)
    Y = torch.randn((Nh, M, 2), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    carry = torch.zeros((M * T - M // 2, 2), device=dev)
    fns += [lambda x=x, M=M: KA.analyze_block(x, M, T, 0),
            lambda x=x, M=M, prev=prev: R.analyze_demod(x, M, T, 0, prev),
            lambda x=x, M=M: K.analyze_phases(x, M, T, 3, 0, torch.bfloat16),
            lambda Y=Y, M=M, carry=carry: S.synthesize_block(Y, M, T, 0,
                                                             carry)]
for Mw in SYNTH_WIDTHS:
    Yw = torch.randn((Nh, Mw, 2), device=dev,
                      generator=torch.Generator(dev).manual_seed(Mw))
    cw = torch.zeros((Mw * T - Mw // 2, 2), device=dev)
    fns.append(lambda Yw=Yw, cw=cw, Mw=Mw: S.synthesize_block(Yw, Mw, T, 0,
                                                               cw))
for f in fns:
    f()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(40):
        for f in fns:
            f()
    torch.cuda.synchronize()
out = {}
for e in prof.key_averages():
    m = re.search(r"(analysis|rx_front|rx_phases|synth)_kernel<(\d+)", e.key)
    if m:
        k = f"{m.group(1)}_kernel<{m.group(2)}>"
        out[k] = (e.device_time_total / e.count / 1e3, e.count)
print("PROF " + json.dumps(out))
'''


def libraries(tree):
    """The tree's main library and its 8192 and 16384 libraries, built by
    the tree's own kernels.build."""
    r = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, sys.argv[1]);"
                        "from amps_tpu_torch.kernels import build;"
                        "print(build.build(widths=[8192, 16384])[0]);"
                        "print(build.library_path(8192));"
                        "print(build.library_path(16384))", tree],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(r.stderr[-3000:])
    return r.stdout.strip().splitlines()[-3:]


def demangle(names):
    for tool in ("/usr/local/cuda/bin/cu++filt", "c++filt"):
        try:
            r = subprocess.run([tool], input="\n".join(names),
                               capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if r.returncode == 0:
            return r.stdout.splitlines()
    # the anonymous namespace's name carries a per-build hash
    return [re.sub(r"_GLOBAL__N__\w+?_\d+", "", n) for n in names]


def kernel_key(name):
    """The pairing key of a demangled function: its name and template
    arguments, without return type, namespace, cu++filt's casts and
    parameter list, and without a last template argument ``false`` (a
    kernel's default instantiation: ``analysis_kernel<1024>`` of a tree
    before the long-filter instantiations pairs with
    ``analysis_kernel<1024, false>`` after them).  cu++filt writes
    ``void <unnamed>::analysis_kernel<(int)1024, (bool)0>(const float
    *, ...)``, c++filt ``void (anonymous namespace)::analysis_kernel<1024,
    false>(float const*, ...)``: both give ``analysis_kernel<1024>``."""
    name = re.sub(r"<unnamed>::|\(anonymous namespace\)::|^void ", "", name)
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    name = re.sub(r"\((?:unsigned )?int\)", "", name)
    return re.sub(r", false>$", ">", name.split("(")[0].strip())


def sass(lib):
    """{kernel_key: [instruction text]} of a library's functions."""
    out = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                         text=True, timeout=600).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]+\*/", "", line).split(";")[0].strip()
            funcs[name].append(ins)
    return {kernel_key(n): v
            for n, v in zip(demangle(list(funcs)), funcs.values())}


def profile(tree):
    r = subprocess.run([sys.executable, "-c", _PROFILE, tree],
                       capture_output=True, text=True, timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("PROF ")]
    if r.returncode or not line:
        raise RuntimeError(r.stderr[-3000:])
    return json.loads(line[0][5:])


def compare_sass(old, new):
    """Print each paired function whose SASS differs, the functions only
    one tree has, and the count of identical ones."""
    code = {side: {k: v for lib in libraries(tree)
                   for k, v in sass(lib).items()}
            for side, tree in (("old", old), ("new", new))}
    same = 0
    for name in sorted(set(code["new"]) - set(code["old"])):
        print(f"  {name[:80]}: only in the new tree")
    for name in sorted(code["old"]):
        a, b = code["old"][name], code["new"].get(name)
        if a == b:
            same += 1
        elif b is None:
            print(f"  {name[:80]}: missing in the new tree")
        else:
            pairs = [(x, y) for x, y in zip(a, b) if x != y]
            diff = len(pairs) + abs(len(a) - len(b))
            print(f"  {name[:80]}: {len(a)} vs {len(b)} instructions, "
                  f"{diff} differ, first: "
                  + " | ".join(f"{x} -> {y}" for x, y in pairs[:2]))
    paired = len(set(code["old"]) & set(code["new"]))
    print(f"SASS identical: {same} of {paired} paired functions "
          f"({len(code['old'])} in the old tree, {len(code['new'])} in the "
          f"new)")


def main(old, new):
    compare_sass(old, new)
    runs = []
    for i in range(TURNS):
        order = (("old", old), ("new", new))
        for side, tree in order[:: 1 if i % 2 == 0 else -1]:
            runs.append((side, profile(tree)))
    for k in sorted(runs[0][1]):
        for side in ("old", "new"):
            v = sorted(r[k][0] for s, r in runs if s == side)
            print(f"{k:18s} {side}: " + " ".join(f"{t:.4f}" for t in v)
                  + f"  median {v[len(v) // 2]:.4f} ms")


if __name__ == "__main__":
    main(*map(os.path.abspath, sys.argv[1:3]))
