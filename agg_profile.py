#!/usr/bin/env python3
"""Profile K2 and K6 (small-key partial aggregates), K14, K17, K8 and K13 of the PyTorch port on one GPU.

    python3 agg_profile.py [--package DIR] [--variants] [--parts k2,k6,...] [--seed N]
                           [--out FILE]

It runs TPC-H Q1 at SF1 and the forward as-of join over bench.py's ticks
(chip_smoke.py's data and queries) through this checkout's
quokka_tpu_torch and, with ``--package``, through another checkout's
(e.g. the parent commit unpacked with ``git archive``), and keeps in each
the K2 call of the largest batch on each path: Q1's (2^20 rows, 17
buckets, three plain float64 inputs and two expressions) and the forward
as-of's (its largest batch, 129 buckets, ``sum(notional), count(*)``).
It keeps K6's largest call and largest one-hot aggregate
(``FusedPartialAgg._onehot``: K6's pre-pass and K6; in an older package
K5, its copies and K6) on Q1, Q4 and Q5 under ``groupby=sort``, times K6
alone (twice, and the other package's K6 on its own Q1 call: the
signatures differ) beside one ``torch.mm(onehot.T, stacked)``, then each
package's whole one-hot aggregate on this checkout's batches in turns;
and, through ``QuokkaContext(mesh=make_mesh(8))``, the
arguments of K14's largest call on mesh Q3 and on mesh Q5.  It keeps
K17's largest call on Q3 under ``shuffle=compacted`` (2^20 rows, 2 parts)
and also times K17 at 64 parts on the same rows and at 2^24 rows made
from the seed (2 and 64 parts), and at 2^24 + 3 rows (2 parts); and it keeps the parts of Q3's and
Q5's largest compacting concats, which both packages' ``bridge.concat_batches``
and K8 (``bridge.compact_concat``) join (the other package's on its own
batch classes), with this checkout's plain version beside them, and Q3's
parts again with validity made from the seed at live shares 0.02, 0.1,
0.5 and 1.0 (``K8_SHARES``).  It keeps K13's largest call on Q13 (a left
join) and times K13 there and on chip_smoke.py's skewed case (one probe
key x 10^4 build rows).  It calls each wrapper of both packages in turns
(package, this, this, package) and reports per call:

- the wrapper's ms, CUDA events over many calls;
- the host ms, time.perf_counter over calls issued with no
  synchronisation;
- the device us of every device operation of the call (kernels, memsets,
  copies: the profiler's device events), in all and by operation, with
  each operation's count per call;
- the allocations per call (the caching allocator's requests);
- whether the call made a host read;

beside the bound, the bytes the function must move over 3.35 TB/s (K2:
the plan's input columns, the key codes and the mask read once, each
bucket's sums and smallest row written; K6: each distinct column, the
codes and mask, and its outputs; K14: 9 B a rank and 5 B a probe row written; K17: the
ids and validity read and the permutation written, 9 B a row; K8: every
part row's validity byte, each live row of each column read and the
bucket of each column and of the validity written; K13: chip_smoke.py's
``k13_bytes``).  It checks
every call against the plain version of this checkout (K2 and K6: counts,
integer sums and smallest rows exact, float sums within rtol 1e-9; the
whole one-hot aggregates against this checkout's; K14, K17, K8 and K13
bit for bit), checks that two launches of this checkout's K2 and K6 give
the same bits, and compiles csrc/onehot.cu, csrc/join.cu, csrc/partition.cu and
csrc/concat.cu with ``-Xptxas -v``
(vector_profile.py's compile_sources) to keep each kernel's registers,
shared memory and spills.  With ``--variants`` it also builds the bucket
core from copies of csrc/onehot.cu patched here (``CORE_VARIANTS``, each
(text, replacement) pair must match once; some leave out part of the work,
to show what it costs, and their results are reported, not checked) and
times each at K2's two shapes, builds K6 the same way from
``ONEHOT_VARIANTS`` and times each at K6's shapes, and builds K17's and K8's
``COMPACT_VARIANTS`` and K13's ``EXPAND_VARIANTS`` the same way: K8's
time each at Q3's and Q5's concats and at every live share, K13's at its
two shapes.  ``--parts`` keeps some of k2, k6, k14, k17, k8 and k13 (all
by default).

It prints the card's name and power limit, one line per measurement and
one JSON line, and writes the JSON to ``--out``.  It imports neither JAX
nor quokka_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PARTS = ("k2", "k6", "k14", "k17", "k8", "k13")
K2_SHAPES = ("q1", "asof forward")
K6_PATHS = ("q1 sort", "q4 sort", "q5 sort")
K14_SHAPES = ("mesh q3", "mesh q5")
K17_ROWS = 1 << 24  # the made inputs' rows, and 3 more for one more tile
SOURCES = ("onehot", "join", "partition", "hashtable", "asof", "pack")
_RUNS = """    const unsigned eq = __match_any_sync(0xffffffffu, g);
    const int size = __popc(eq);
    const bool lead = (eq & lower) == 0u;  // the run's first lane
    int start = lead ? size : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, start, d);
      if (lane >= d) start += y;
    }
    start -= lead ? size : 0;
    const int head = __shfl_sync(0xffffffffu, start, __ffs(eq) - 1);
"""
# the runs in bucket order: one ballot per bit of the bucket id gives the
# lanes of lower buckets (less) and of the same bucket (eq)
_RUNS_BY_BALLOTS = """    const int nbits = 32 - __clz(G);
    unsigned ones[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) ones[b] = b < nbits ? __ballot_sync(0xffffffffu, (g >> b) & 1) : 0u;
    unsigned eq = 0xffffffffu, less = 0u;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      if (b >= nbits) continue;
      const bool bit = (g >> b) & 1;
      if (bit) less |= eq & ~ones[b];
      eq &= bit ? ones[b] : ~ones[b];
    }
    const int size = __popc(eq);
    const bool lead = (eq & lower) == 0u;
    const int head = __popc(less);
"""
# the bucket core (csrc/onehot.cu) built with these (text, replacement)
# patches: an ablation that leaves out the columns' sums (its results are
# not the function's); the runs in bucket order; scans of five levels;
# another grid
CORE_VARIANTS = {
    "no column sums (ablation)": [("    for (int a0 = 0; a0 < C; a0 += QK_AGG_PREFETCH) {\n",
                                   "    for (int a0 = C; a0 < C; a0 += QK_AGG_PREFETCH) {\n")],
    "runs in bucket order (a ballot per bit of the bucket id)": [(_RUNS, _RUNS_BY_BALLOTS)],
    "every scan five levels": [("    if (d >= widest) break;\n", "")],
    "four warps a block": [("  warps = warps > QK_AGG_WARPS ? QK_AGG_WARPS : warps;",
                            "  warps = warps > 4 ? 4 : warps;")],
}


_MMA_K8 = """  const int k0 = bk[0], k1 = bk[4];
  const double a0 = k0 == m ? 1.0 : 0.0, a1 = k0 == m + 8 ? 1.0 : 0.0;
  const double a2 = k1 == m ? 1.0 : 0.0, a3 = k1 == m + 8 ? 1.0 : 0.0;
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b[0]), "d"(b[4]));
"""
_MMA_K4 = """  const int k0 = bk[0];
  const double a0 = k0 == m ? 1.0 : 0.0, a1 = k0 == m + 8 ? 1.0 : 0.0;
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b[0]));
"""
_MMA_K16 = """  double a[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[2 * j] = bk[4 * j] == m ? 1.0 : 0.0;
    a[2 * j + 1] = bk[4 * j] == m + 8 ? 1.0 : 0.0;
  }
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[4]), "d"(b[8]), "d"(b[12]));
"""
_K16_ROWS = "#define QK_OH_K 16         // rows an MMA takes"
# K6 (csrc/onehot.cu's qk_onehot_mma_kernel) built with these (text,
# replacement) patches: sm_90's smaller f64 MMA shapes, three stages, one
# block an SM, smaller tiles, and ablations that leave out the product,
# the conversion pass or the scan for special values (their results are
# not the function's, and are reported, not checked)
ONEHOT_VARIANTS = {
    "m16n8k8": [(_K16_ROWS, _K16_ROWS.replace("16 ", "8  ")), (_MMA_K16, _MMA_K8)],
    "m16n8k4": [(_K16_ROWS, _K16_ROWS.replace("16 ", "4  ")), (_MMA_K16, _MMA_K4)],
    "three stages": [("#define QK_OH_STAGES 2 ", "#define QK_OH_STAGES 3 ")],
    "one block an SM": [("#define QK_OH_BLOCKS_PER_SM 2", "#define QK_OH_BLOCKS_PER_SM 1")],
    "256-row tiles": [("#define QK_OH_TILE 512", "#define QK_OH_TILE 256")],
    "no product (ablation)": [("    for (int s = s_lo; s < s_hi; s += C) {",
                               "    for (int s = s_hi; s < s_hi; s += C) {")],
    "no conversion (ablation)": [("      for (int c = 0; c < ncol; ++c) {",
                                  "      for (int c = ncol; c < ncol; ++c) {")],
    "no scan for NaN, infinities and nulls (ablation)": [
        ("if (((watch >> s) & 1u) && qk_oh_special(", "if (((watch >> s) & 0u) && qk_oh_special(")],
}


# csrc/partition.cu (K17) and csrc/concat.cu (K8) built with these
# (text, replacement) patches: other choices of the stable-compaction core
# (K17's ranking by rounds of warp peers, K8's wider look-back steps, one
# load a thread in flight, larger zeroing blocks) and ablations that leave
# out one step (their results are not the function's, and are reported,
# not checked)
COMPACT_VARIANTS = {
    "K17 rounds of warp peers at every bucket count": ("partition", [(
        "  if (nb <= QK_PLAN_SMALL)\n", "  if (nb <= 0)\n")]),
    "K17 groups of a power of two tiles (the earlier choice)": ("partition", [(
        "  long long g = (long long)sqrt((double)nt);\n  while (g * g < nt) ++g;\n",
        "  long long g = 16;\n  while (g * g < nt) g *= 2;\n")]),
    "K17 no perm writes (ablation)": ("partition", [(
        "    perm[sh.dst[x >> 16] + i] =", "    if (t0 < 0) perm[sh.dst[x >> 16] + i] =")]),
    "K8 look-back of 8 words a lane": ("concat", [(
        "#define QK_CAT_LOOK 2 ", "#define QK_CAT_LOOK 8 ")]),
    "K8 one load a thread in flight": ("concat", [(
        "  constexpr int kFlight = sizeof(V) <= 8 ? 4 : 1;", "  constexpr int kFlight = 1;")]),
    "K8 zeroing blocks of 16384 rows": ("concat", [(
        "#define QK_CAT_ZERO_ROWS 4096", "#define QK_CAT_ZERO_ROWS 16384")]),
    "K8 no column copies (ablation)": ("concat", [(
        "  for (int ci = 0; ci < n_cols; ++ci) {\n    const QkCatCol col = cols[ci];",
        "  for (int ci = 0; ci < 0; ++ci) {\n    const QkCatCol col = cols[ci];")]),
    "K8 no zeroed tail (ablation)": ("concat", [(
        "      qk_cat_zero(cols[c].dst, zlo * wd, hi * wd);",
        "      if (wd < 0) qk_cat_zero(cols[c].dst, zlo * wd, hi * wd);")]),
}

# K8's made live shares: Q3's largest concat's parts with validity made from
# the seed at each share
K8_SHARES = (0.02, 0.1, 0.5, 1.0)

# csrc/join.cu built with these (text, replacement) patches: K13 with other
# merged items a thread (a block's shared slice grows with them)
EXPAND_VARIANTS = {
    "K13 4 merged items a thread": [("#define QK_MM_VT 8 ", "#define QK_MM_VT 4 ")],
    "K13 6 merged items a thread": [("#define QK_MM_VT 8 ", "#define QK_MM_VT 6 ")],
}


def compact_variant_sources() -> dict:
    """{label: .cu path} of COMPACT_VARIANTS, written into build/agg_profile/
    beside a copy of csrc/compact.cuh."""
    from quokka_tpu_torch.ops import native

    out_dir = ROOT / "build" / "agg_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "compact.cuh").write_text((native.CSRC_DIR / "compact.cuh").read_text())
    out = {}
    for i, (source, patches) in enumerate(COMPACT_VARIANTS.values()):
        src = (native.CSRC_DIR / f"{source}.cu").read_text()
        for a, b in patches:
            if src.count(a) != 1:
                raise RuntimeError(f"compact variant {i}: {a!r} is not once in csrc/{source}.cu")
            src = src.replace(a, b)
        path = out_dir / f"compact_variant_{i}.cu"
        path.write_text(src)
        out[f"compact_variant_{i}"] = path
    return out


def expand_variant_sources() -> dict:
    """{label: .cu path} of EXPAND_VARIANTS, written into build/agg_profile/
    beside copies of the headers csrc/join.cu includes."""
    from quokka_tpu_torch.ops import native

    out_dir = ROOT / "build" / "agg_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in native.CSRC_DIR.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    base = (native.CSRC_DIR / "join.cu").read_text()
    out = {}
    for i, patches in enumerate(EXPAND_VARIANTS.values()):
        src = base
        for a, b in patches:
            if src.count(a) != 1:
                raise RuntimeError(f"expand variant {i}: {a!r} is not once in csrc/join.cu")
            src = src.replace(a, b)
        path = out_dir / f"expand_variant_{i}.cu"
        path.write_text(src)
        out[f"expand_variant_{i}"] = path
    return out


def same_outputs(got, want) -> bool:
    """K13's outputs bit for bit: each tensor equal in dtype and value, or
    both None."""
    import torch

    return all((a is None and b is None) or (a is not None and b is not None
                                             and a.dtype == b.dtype and torch.equal(a, b))
               for a, b in zip(got, want))


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def sums_agree(got, want) -> bool:
    """Per-bucket sums and smallest rows against the plain version's: float
    sums within rtol 1e-9, the rest exact, dtypes equal."""
    import torch

    for a, c in zip(got, want):
        if a.dtype != c.dtype or a.shape != c.shape:
            return False
        if a.is_floating_point():
            if not torch.allclose(a, c, rtol=1e-9, atol=1e-12, equal_nan=True):
                return False
        elif not torch.equal(a, c):
            return False
    return True


def bits(t):
    import torch

    return t.view(torch.int64) if t.dtype == torch.float64 else t


def k2_calls(pkg, dev, tables, ticks):
    """{shape: (the package's SmallCall of the path's largest batch, the
    K2 calls per query)}, captured on the package's own query runs."""
    import chip_smoke

    ctx = pkg.pkg.QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    out = {}
    for shape in K2_SHAPES:
        stream = (chip_smoke.tpch_stream(shape, ctx, tables) if shape == "q1"
                  else chip_smoke.tick_stream(shape, ctx, ticks))
        with chip_smoke.Capture({"K2": (pkg.fuse.FusedPartialAgg, "prepare_small",
                                        lambda self, b: b.padded_len)}) as cap:
            chip_smoke.collect_numpy(stream, shape)
        agg, batch = cap.args["K2"][0]
        out[shape] = (agg.prepare_small(batch), cap.calls["K2"])
    return out


def k6_calls(pkg, dev, tables, paths):
    """{path: Capture of the package's K6 calls (``onehot_agg``, "K6") and
    of its one-hot aggregates (``FusedPartialAgg._onehot``, "one-hot"),
    the largest of each kept} on the package's own groupby=sort runs."""
    import chip_smoke

    ctx = pkg.pkg.QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    out = {}
    os.environ["QK_KERNEL_STRATEGY"] = "groupby=sort"
    try:
        for path in paths:
            with chip_smoke.Capture({
                    "K6": (pkg.fuse, "onehot_agg", lambda *a: a[-1].shape[0]),
                    "one-hot": (pkg.fuse.FusedPartialAgg, "_onehot",
                                lambda a, b, d: b.padded_len)}) as cap:
                chip_smoke.collect_numpy(chip_smoke.tpch_stream(path.split()[0], ctx, tables),
                                         path)
            out[path] = cap
    finally:
        os.environ.pop("QK_KERNEL_STRATEGY")
    return out


def shuffle_calls(pkg, dev, tables):
    """(K17's largest call on Q3 under shuffle=compacted, {q3, q5: the parts
    of the query's largest compacting concat}, K13's largest call on Q13,
    {calls per query}), on the package's runs."""
    import chip_smoke

    ctx = pkg.pkg.QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    os.environ["QK_KERNEL_STRATEGY"] = "shuffle=compacted"
    try:
        with chip_smoke.Capture({"K17": (pkg.kernels, "partition_plan",
                                         lambda p, v, n: v.shape[0])}) as cap17:
            chip_smoke.collect_numpy(chip_smoke.tpch_stream("q3", ctx, tables), "q3 compacted")
    finally:
        os.environ.pop("QK_KERNEL_STRATEGY")
    k8, calls = {}, {"K17 q3 compacted": cap17.calls["K17"]}
    for q in ("q3", "q5"):
        with chip_smoke.Capture({"K8": (pkg.bridge, "compact_concat",
                                        lambda b, pc, d, t, pad: sum(x.padded_len for x in b))}
                                ) as cap8:
            chip_smoke.collect_numpy(chip_smoke.tpch_stream(q, ctx, tables), q)
        k8[q] = cap8.args["K8"][0]
        calls[f"K8 {q}"] = cap8.calls["K8"]
    with chip_smoke.Capture({"K13": (pkg.join, "mm_expand", lambda *a: a[5])}) as cap13:
        chip_smoke.collect_numpy(chip_smoke.tpch_stream("q13", ctx, tables), "q13")
    calls["K13 q13"] = cap13.calls["K13"]
    return cap17.args["K17"][0], k8, cap13.args["K13"][0], calls


def as_package(pkg, parts):
    """The parts as batches of another package's classes (its concat tests
    them with isinstance); parts that shared a dictionary still share one."""
    B, dicts, out = pkg.batch, {}, []
    for b in parts:
        cols = {}
        for name, c in b.columns.items():
            kind = type(c).__name__
            if kind == "StrCol":
                d = c.dictionary
                if id(d) not in dicts:
                    dicts[id(d)] = B.StringDict(d.values, binary=d.binary)
                cols[name] = B.StrCol(c.codes, dicts[id(d)])
            elif kind == "VecCol":
                cols[name] = B.VecCol(c.data)
            else:
                cols[name] = B.NumCol(c.data, c.kind, c.unit)
        out.append(B.DeviceBatch(cols, b.valid, b.nrows, b.sorted_by))
    return out


def same_batch(a, b) -> bool:
    """Bit for bit: live count, validity, and every column's padded rows."""
    import torch

    def data(c):
        t = c.codes if hasattr(c, "codes") else c.data
        return t.view(torch.int64) if t.dtype == torch.float64 else t

    return (a.nrows == b.nrows and torch.equal(a.valid, b.valid)
            and list(a.columns) == list(b.columns)
            and all(data(a.columns[k]).dtype == data(b.columns[k]).dtype
                    and torch.equal(data(a.columns[k]), data(b.columns[k])) for k in a.columns))


def variant_sources(variants=None, prefix="core_variant") -> dict:
    """{label: .cu path} of CORE_VARIANTS (or ONEHOT_VARIANTS, with
    prefix "onehot_variant"), written into build/agg_profile/."""
    from quokka_tpu_torch.ops import native

    base = (native.CSRC_DIR / "onehot.cu").read_text()
    out = {}
    for i, patches in enumerate((variants or CORE_VARIANTS).values()):
        src = base
        for a, b in patches:
            if src.count(a) != 1:
                raise RuntimeError(f"{prefix} {i}: {a!r} is not once in csrc/onehot.cu")
            src = src.replace(a, b)
        path = ROOT / "build" / "agg_profile" / f"{prefix}_{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[f"{prefix}_{i}"] = path
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=None,
                    help="root of another checkout whose quokka_tpu_torch is timed in turns "
                         "with this one's")
    ap.add_argument("--variants", action="store_true",
                    help="also time the bucket core built with each of CORE_VARIANTS, and K17, K8 "
                         "and K13 built with each of COMPACT_VARIANTS and EXPAND_VARIANTS")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"the kernels to profile, a comma-separated subset of {PARTS}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "agg_profile.json"))
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--parts: {sorted(parts - set(PARTS))} not in {PARTS}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("agg_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"agg_profile: no quokka_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    other = Path(args.package).resolve() if args.package else None
    if other is not None and not (other / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"agg_profile: no quokka_tpu_torch package in {other}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))

    import chip_smoke
    from quokka_tpu_torch.ops import native
    from vector_profile import compile_sources, load_package
    from window_profile import call_profile

    built = compile_sources({"onehot": native.CSRC_DIR / "onehot.cu",
                             "join": native.CSRC_DIR / "join.cu",
                             "partition": native.CSRC_DIR / "partition.cu",
                             "concat": native.CSRC_DIR / "concat.cu",
                             **(variant_sources() if args.variants and "k2" in parts else {}),
                             **(variant_sources(ONEHOT_VARIANTS, "onehot_variant")
                                if args.variants and "k6" in parts else {}),
                             **(compact_variant_sources()
                                if args.variants and parts & {"k17", "k8"} else {}),
                             **(expand_variant_sources()
                                if args.variants and "k13" in parts else {})})
    report = {"card": card, "package": str(other) if other else None,
              "ptxas": {k: v for lib in ("onehot", "join", "partition", "concat")
                        for k, v in built[lib][1].items()}}
    dev = torch.device("cuda", 0)
    tables = chip_smoke.make_tpch(1.0, args.seed)
    ticks = chip_smoke.make_ticks(1.0, args.seed)

    # this checkout's calls: K2 on its paths, K6 and the whole one-hot
    # aggregate on Q1, Q4 and Q5 under groupby=sort, K14 on the mesh's Q3
    # and Q5, K17, K8 and K13 on their queries
    this = load_package(ROOT, SOURCES + ("concat",))
    calls = {}
    k2 = {"this": k2_calls(this, dev, tables, ticks)} if "k2" in parts else {}
    if "k2" in parts:
        calls["K2"] = {s: c for s, (_, c) in k2["this"].items()}
    k6 = {"this": k6_calls(this, dev, tables, K6_PATHS)} if "k6" in parts else {}
    for path, cap in k6.get("this", {}).items():
        calls[f"K6 {path}"] = cap.calls["K6"]
    from quokka_tpu_torch.parallel import make_mesh  # this checkout's, loaded last

    k14_args = {}
    if "k14" in parts:
        mctx = this.pkg.QuokkaContext(io_channels=2, exec_channels=2, device=dev,
                                      mesh=make_mesh(8, device=dev))
        for shape in K14_SHAPES:
            build = chip_smoke.mesh_paths(tables, ticks)[shape][0]
            with chip_smoke.Capture({"K14": (this.join, "pk_match_ranks",
                                             lambda r, v, p: v.shape[0])}) as cap:
                chip_smoke.collect_numpy(build(mctx), shape)
            k14_args[shape] = cap.args["K14"][0]
            calls[f"K14 {shape}"] = cap.calls["K14"]
        del mctx
    if parts & {"k17", "k8", "k13"}:
        k17_args, k8_args, k13_args, more = shuffle_calls(this, dev, tables)
        calls.update(more)
    report["calls_per_query"] = calls
    print(f"calls per query: {calls}", flush=True)

    pkgs = {"this": this}
    if other is not None:
        pkgs["package"] = load_package(other, SOURCES)
        if "k2" in parts:
            k2["package"] = k2_calls(pkgs["package"], dev, tables, ticks)
        if "k6" in parts:
            k6["package"] = k6_calls(pkgs["package"], dev, tables, K6_PATHS)
    turns = ["package", "this", "this", "package"] if other is not None else ["this", "this"]

    report["k2"], want_k2 = {}, {}
    for shape in K2_SHAPES if "k2" in parts else ():
        call = k2["this"][shape][0]
        want = call.plain()
        outs = sum(nbytes(x) for x in want[0]) + nbytes(want[1])
        plains = {t: want if t == "this" else k2[t][shape][0].plain() for t in set(turns)}
        want_k2[shape] = want[0] + [want[1]]
        bound = nbytes(*call.inputs.values(), *call.codes, call.valid) + outs
        entry = {"shape": f"{call.valid.shape[0]} rows ({int(call.valid.sum())} valid), "
                          f"{call.n_groups + 1} buckets, partials "
                          f"{[op for _, op, _ in call.partials]}, inputs "
                          f"{ {k: str(t.dtype) for k, t in call.inputs.items()} }, pre-pass "
                          f"outputs {call.kern.pre_outs}",
                 "bound_ms": bound / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K2 {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        for t in turns:
            c = k2[t][shape][0]
            row = call_profile(f"K2 {shape} ({t})", c.launch, 50)
            got, exp = c.launch(), plains[t]
            row["matches_plain"] = sums_agree(got[0] + [got[1]], exp[0] + [exp[1]])
            if t == "this":
                again = c.launch()
                row["same_bits"] = all(torch.equal(bits(a), bits(b))
                                       for a, b in zip(got[0] + [got[1]], again[0] + [again[1]]))
            entry["turns"].append({"package": t, **row})
        report["k2"][shape] = entry

    # K6 alone: this checkout's core at Q1, Q4 and Q5 sort's largest calls
    # (twice each) beside its bound and one torch.mm(onehot.T, stacked);
    # the other package's K6 on its own Q1 call (its own signature, so not
    # like for like).  Then the whole one-hot aggregate (FusedPartialAgg's
    # _onehot: pre-pass, K5 and copies where they run, and K6) of each
    # package on this checkout's Q1, Q4 and Q5 batches, in turns
    report["k6"], report["one-hot aggregate"] = {}, {}
    for path, cap in k6.get("this", {}).items():
        if "K6" not in cap.args:
            report["k6"][path] = {"skipped": "every batch took the general path past the "
                                             "one-hot gate", "turns": []}
            print(f"K6 {path}: skipped, past the one-hot gate", flush=True)
            continue
        a = cap.args["K6"][0]
        cols, tags, nf, co, st, g, va = a
        want = this.fuse.onehot_agg_plain(*a)
        srcs = {(c.data_ptr(), c.dtype): c for c in cols}.values()
        entry = {"shape": f"{va.shape[0]} rows, {g + 1} buckets, {len(cols)} entries ({nf} "
                          f"float) over {len(srcs)} columns, tags {list(tags)}",
                 "bound_ms": (nbytes(*srcs, *co, va) + sum(nbytes(x) for x in want))
                 / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K6 {path}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        for _ in range(2):
            fn = lambda: this.fuse.onehot_agg_cuda(*a)  # noqa: E731
            row = call_profile(f"K6 {path} (this)", fn, 50)
            got = fn()
            row["matches_plain"] = sums_agree(got, want)
            row["same_bits"] = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, fn()))
            entry["turns"].append({"package": "this", **row})
        if path == "q1 sort" and "package" in k6:
            pa = k6["package"][path].args["K6"][0]
            fn = lambda: pkgs["package"].fuse.onehot_agg_cuda(*pa)  # noqa: E731
            row = call_profile(f"K6 {path} (package, its own call)", fn, 50)
            row["matches_plain"] = sums_agree(fn(), pkgs["package"].fuse.onehot_agg_plain(*pa))
            entry["turns"].append({"package": "package", **row})
        gid = this.fuse._bucket_ids(co, st, va, g)
        onehot = (gid[:, None] == torch.arange(g + 1, device=dev)[None, :]).to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        stacked = torch.stack([torch.where(va, this.fuse._tagged_addends(c, t).to(torch.float64),
                                           zero) for c, t in zip(cols, tags)]
                              + [va.to(torch.float64)], 1)
        entry["torch.mm"] = call_profile(f"torch.mm(onehot.T, stacked) {path}",
                                         lambda: torch.mm(onehot.T, stacked), 50)
        del onehot, stacked
        report["k6"][path] = entry

        agg, batch, dims = cap.args["one-hot"][0]
        mine = agg._onehot(batch, dims)
        whole = {"shape": entry["shape"], "turns": []}
        for t in turns:
            if t == "this":
                fn = lambda: agg._onehot(batch, dims)  # noqa: E731
            elif "one-hot" not in k6[t][path].args:
                continue
            else:  # the package's own aggregate object, on this checkout's batch
                theirs = k6[t][path].args["one-hot"][0][0]
                other_batch = as_package(pkgs[t], [batch])[0]
                fn = lambda f=theirs, b=other_batch: f._onehot(b, dims)  # noqa: E731
            row = call_profile(f"one-hot aggregate {path} ({t})", fn, 50)
            got = fn()
            row["matches_plain"] = sums_agree(got[0] + [got[1]], mine[0] + [mine[1]])
            whole["turns"].append({"package": t, **row})
        report["one-hot aggregate"][path] = whole

    if args.variants and "k6" in parts:
        import ctypes

        prod = this.fuse._onehot_lib()
        report["onehot_variants"] = {}
        for i, label in enumerate(ONEHOT_VARIANTS):
            lib = ctypes.CDLL(str(built[f"onehot_variant_{i}"][0]))
            lib.qk_onehot_agg.argtypes = prod.qk_onehot_agg.argtypes
            lib.qk_onehot_agg.restype = prod.qk_onehot_agg.restype
            this.fuse._onehot_lib = lambda lib=lib: lib
            rows = {"ptxas": built[f"onehot_variant_{i}"][1]}
            for path, cap in k6["this"].items():
                if "K6" not in cap.args:
                    continue
                a = cap.args["K6"][0]
                fn = lambda: this.fuse.onehot_agg_cuda(*a)  # noqa: E731
                rows[f"K6 {path}"] = call_profile(f"K6 {path}, variant: {label}", fn, 50)
                rows[f"K6 {path}"]["matches_plain"] = sums_agree(
                    fn(), this.fuse.onehot_agg_plain(*a))
            report["onehot_variants"][label] = rows
        this.fuse._onehot_lib = lambda: prod

    if args.variants and "k2" in parts:
        import ctypes

        prod = this.fuse._bucket_lib()
        report["core_variants"] = {}
        for i, label in enumerate(CORE_VARIANTS):
            lib = ctypes.CDLL(str(built[f"core_variant_{i}"][0]))
            lib.qk_small_agg.argtypes = prod.qk_small_agg.argtypes
            lib.qk_small_agg.restype = prod.qk_small_agg.restype
            this.fuse._bucket_lib = lambda lib=lib: lib
            rows = {"ptxas": built[f"core_variant_{i}"][1]}
            for shape in K2_SHAPES:
                call = k2["this"][shape][0]
                rows[f"K2 {shape}"] = call_profile(f"K2 {shape}, variant: {label}", call.launch, 50)
                got = call.launch()
                rows[f"K2 {shape}"]["matches_plain"] = sums_agree(got[0] + [got[1]],
                                                                  want_k2[shape])
            report["core_variants"][label] = rows
        this.fuse._bucket_lib = lambda: prod

    report["k14"] = {}
    for shape in K14_SHAPES if "k14" in parts else ():
        ranks, valid, p = k14_args[shape]
        n = valid.shape[0]
        want = this.join._pk_match_plain(ranks, valid, p)
        entry = {"shape": f"one shard: {p} probe + {n - p} build rows, {int(want[1].sum())} "
                          "matched",
                 "bound_ms": (9 * n + 5 * p) / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K14 {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        for t in turns:
            fn = lambda t=t: pkgs[t].join.pk_match_ranks(ranks, valid, p)  # noqa: E731
            row = call_profile(f"K14 {shape} ({t})", fn, 20)
            row["matches_plain"] = all(a.dtype == b.dtype and torch.equal(a, b)
                                       for a, b in zip(fn(), want))
            entry["turns"].append({"package": t, **row})
        report["k14"][shape] = entry

    if "k17" in parts:
        # K17 at Q3 compacted's largest split, at 64 parts on the same rows, and
        # at 2^24 and 2^24 + 3 rows made from the seed
        k17_p, k17_v, k17_n = k17_args
        r = np.random.default_rng(args.seed)
        more_v = torch.from_numpy(r.random(K17_ROWS + 3) < 0.8).to(dev)
        more_p = torch.from_numpy(r.integers(0, 64, K17_ROWS + 3).astype(np.int32)).to(dev)
        big_v, big_p = more_v[:K17_ROWS], more_p[:K17_ROWS]
        k17_cases = {"q3 compacted": (k17_p, k17_v, k17_n),
                     "q3 compacted, 64 parts": (k17_p * 31 % 64, k17_v, 64),
                     "2^24 rows, 2 parts": (big_p % 2, big_v, 2),
                     "2^24 rows, 64 parts": (big_p, big_v, 64),
                     "2^24 + 3 rows, 2 parts": (more_p % 2, more_v, 2)}
        report["k17"] = {}
        for label, (pids, valid, n_parts) in k17_cases.items():
            n = valid.shape[0]
            want = this.kernels.partition_plan_plain(pids, valid, n_parts)
            entry = {"shape": f"{n} rows ({int(valid.sum())} valid), {n_parts} parts",
                     "bound_ms": (9 * n + 8 * n_parts) / HBM_BYTES_PER_S * 1e3, "turns": []}
            print(f"K17 {label}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
            for t in turns:
                fn = lambda t=t: pkgs[t].kernels.partition_plan(pids, valid, n_parts)  # noqa: E731
                row = call_profile(f"K17 {label} ({t})", fn, 20)
                row["matches_plain"] = all(a.dtype == b.dtype and torch.equal(a, b)
                                           for a, b in zip(fn(), want))
                entry["turns"].append({"package": t, **row})
            report["k17"][label] = entry

    if "k8" in parts:
        # K8 at Q3's and Q5's largest compacting concats (both packages'
        # concat_batches and K8, in turns), then this checkout's plain version;
        # and both packages' K8 on Q3's parts at the made live shares
        r8 = np.random.default_rng(args.seed + 8)
        k8_cases = dict(k8_args)
        q3_parts = k8_args["q3"][0]
        for share in K8_SHARES:
            made = []
            for b in q3_parts:
                v = torch.from_numpy(r8.random(b.padded_len) < share).to(dev)
                made.append(this.batch.DeviceBatch(b.columns, v, int(v.sum()), b.sorted_by))
            per_col, dicts = this.bridge._concat_parts(made)
            total = sum(b.nrows for b in made)
            k8_cases[f"q3 parts, live {share}"] = (made, per_col, dicts, total,
                                                   this.pkg.config.bucket_size(total))
        report["k8"], want_k8 = {}, {}
        for label, (k8_parts, per_col, dicts, total, padded) in k8_cases.items():
            by_pkg = {t: k8_parts if t == "this" else as_package(pkgs[t], k8_parts)
                     for t in set(turns)}
            widths = [this.bridge._row_bytes(this.bridge._promoted(p), p[0].shape[1:])
                      for p in per_col.values()]
            lens = [b.padded_len for b in k8_parts]
            want = want_k8[label] = this.bridge.compact_concat_plain(
                k8_parts, per_col, dicts, total, padded)
            entry = {"shape": f"{len(k8_parts)} parts of {lens} rows, {total} live, bucket "
                              f"{padded}, {len(widths)} columns of {widths} B",
                     "bound_ms": (sum(lens) + total * sum(widths) + padded * (sum(widths) + 1))
                     / HBM_BYTES_PER_S * 1e3, "turns": [], "k8_turns": []}
            print(f"K8 {label}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
            for t in turns:
                if label in k8_args:
                    fn = lambda t=t: pkgs[t].bridge.concat_batches(by_pkg[t])  # noqa: E731
                    row = call_profile(f"concat_batches {label} ({t})", fn, 20)
                    row["matches_plain"] = same_batch(fn(), want)
                    entry["turns"].append({"package": t, **row})
                fn = lambda t=t: pkgs[t].bridge.compact_concat(  # noqa: E731
                    by_pkg[t], per_col, dicts, total, padded)
                row = call_profile(f"K8 {label} ({t})", fn, 20)
                row["matches_plain"] = same_batch(fn(), want)
                entry["k8_turns"].append({"package": t, **row})
            if label in k8_args:
                fn = lambda: this.bridge.compact_concat_plain(  # noqa: E731
                    k8_parts, per_col, dicts, total, padded)
                row = call_profile(f"plain version {label}", fn, 20)
                row["matches_plain"] = same_batch(fn(), want)
                entry["plain version"] = row
            report["k8"][label] = entry

    if "k13" in parts:
        # K13 at Q13's largest expand and on the skewed case, in turns
        sk_a, _ = chip_smoke.k13_skew_case(
            dev, torch.Generator(device="cpu").manual_seed(args.seed + 13))
        k13_cases = {label: (torch.cumsum(a[0], 0), a)
                     for label, a in (("q13", k13_args), ("one key x 10^4 build rows", sk_a))}
        report["k13"], want_k13 = {}, {}
        for label, (cum, a) in k13_cases.items():
            want = want_k13[label] = this.join._mm_expand_plain(cum, *a[1:])
            entry = {"shape": f"{a[5]} output rows ({int(a[4])} live), {a[0].shape[0]} probe rows, "
                              f"{a[2].shape[0]} build rows, "
                              f"{'left' if a[6] is not None else 'inner'}",
                     "bound_ms": chip_smoke.k13_bytes(a, cum) / HBM_BYTES_PER_S * 1e3, "turns": []}
            print(f"K13 {label}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
            for t in turns:
                fn = lambda t=t: pkgs[t].join._mm_expand_cuda(cum, *a[1:])  # noqa: E731
                row = call_profile(f"K13 {label} ({t})", fn, 20)
                row["matches_plain"] = same_outputs(fn(), want)
                if t == "this":
                    row["same_bits"] = same_outputs(fn(), fn())
                entry["turns"].append({"package": t, **row})
            report["k13"][label] = entry

    if args.variants and parts & {"k17", "k8", "k13"}:
        import ctypes

        libs = {"partition": (this.kernels, "_partition_lib",
                              ("qk_plan_scratch", "qk_partition_plan")),
                "concat": (this.bridge, "_concat_lib", ("qk_concat_scratch", "qk_concat"))}
        report["compact_variants"] = {}
        for i, (label, (source, _)) in enumerate(COMPACT_VARIANTS.items()):
            if {"partition": "k17", "concat": "k8"}[source] not in parts:
                continue
            mod, attr, fns = libs[source]
            prod = getattr(mod, attr)()
            lib = ctypes.CDLL(str(built[f"compact_variant_{i}"][0]))
            for fn in fns:
                getattr(lib, fn).argtypes = getattr(prod, fn).argtypes
                getattr(lib, fn).restype = getattr(prod, fn).restype
            setattr(mod, attr, lambda lib=lib: lib)
            rows = {"ptxas": built[f"compact_variant_{i}"][1]}
            if source == "partition":
                for shape in ("q3 compacted", "2^24 rows, 2 parts", "2^24 + 3 rows, 2 parts"):
                    pids, valid, n_parts = k17_cases[shape]
                    fn = lambda: this.kernels.partition_plan(pids, valid, n_parts)  # noqa: E731
                    rows[f"K17 {shape}"] = call_profile(f"K17 {shape}, variant: {label}", fn, 20)
                    rows[f"K17 {shape}"]["matches_plain"] = all(
                        torch.equal(a, b) for a, b in zip(
                            fn(), this.kernels.partition_plan_plain(pids, valid, n_parts)))
            else:
                for case, (k8_parts, per_col, dicts, total, padded) in k8_cases.items():
                    fn = lambda: this.bridge.compact_concat(  # noqa: E731
                        k8_parts, per_col, dicts, total, padded)
                    rows[f"K8 {case}"] = call_profile(f"K8 {case}, variant: {label}", fn, 20)
                    rows[f"K8 {case}"]["matches_plain"] = same_batch(fn(), want_k8[case])
            setattr(mod, attr, lambda prod=prod: prod)
            report["compact_variants"][label] = rows
        prod = this.join._join_lib()
        report["expand_variants"] = {}
        for i, label in enumerate(EXPAND_VARIANTS if "k13" in parts else ()):
            lib = ctypes.CDLL(str(built[f"expand_variant_{i}"][0]))
            lib.qk_mm_expand.argtypes = prod.qk_mm_expand.argtypes
            lib.qk_mm_expand.restype = prod.qk_mm_expand.restype
            this.join._join_lib = lambda lib=lib: lib
            rows = {"ptxas": built[f"expand_variant_{i}"][1]}
            for case, (cum, a) in k13_cases.items():
                fn = lambda: this.join._mm_expand_cuda(cum, *a[1:])  # noqa: E731
                rows[f"K13 {case}"] = call_profile(f"K13 {case}, variant: {label}", fn, 20)
                rows[f"K13 {case}"]["matches_plain"] = same_outputs(fn(), want_k13[case])
            report["expand_variants"][label] = rows
        this.join._join_lib = lambda: prod

    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    wrong = [f"{k} {s} {r['package']}"
             for k in ("k2", "k6", "one-hot aggregate", "k14", "k17", "k8", "k13") if k in report
             for s, e in report[k].items() for r in e["turns"] + e.get("k8_turns", [])
             if not r["matches_plain"] or r.get("same_bits") is False]
    wrong += [f"k8 {s} plain version" for s, e in report.get("k8", {}).items()
              if "plain version" in e and not e["plain version"]["matches_plain"]]
    if wrong:
        print(f"agg_profile: results differ from the plain version or between launches: "
              f"{wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
