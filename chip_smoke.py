#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quokka_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--sf 1.0] [--parent DIR]

Phases, each fatal on failure:
  1. print the card (nvidia-smi name, power.limit) and torch/CUDA versions;
  2. build the CUDA C++ kernels from the sources in this checkout
     (one nvcc per source, in parallel) and print the build seconds;
  3. make TPC-H tables at scale factor --sf with numpy from --seed (6.0M
     lineitem, 1.5M orders, 150K customer, 200K part, 10K supplier, 25
     nation and 5 region rows at SF1; the domains of tests/tpch_data.py),
     bench.py's ticks (1.15M trades, 6M quotes, 100 symbols), and clustered
     embeddings at ann-benchmarks glove-100-angular's shape (1,183,514 x
     100 float32 at SF1, 0.1% null, 10,000 queries) as an Arrow table, a
     2^18-row Parquet file of the same distribution in 16 row groups with
     its IVF sidecar (built on the card), and their float64 oracles;
  4. run TPC-H Q1, Q3 (join_build=hashtable, then join_build=sort), Q5,
     Q4, Q13, Q19, Q7 and Q21 (three distincts over lineitem, held to a
     numpy oracle that dedupes the (order, supplier) pairs), then the
     time-series tier over the ticks (the backward asof backtest under
     asof=searchsorted, then asof=sort, the forward asof, tumbling,
     hopping, session and sliding windows, shift)
     through the port's own QuokkaContext on the card, then the vector tier
     (exact nearest_neighbors, k = 10, over the corpus in 2^20-row
     batches; the approximate search over the Parquet file, nprobe 4; the
     gramian and covariance of four lineitem columns and approximate
     quantiles of l_extendedprice), then the exchange and strategy rows:
     Q3, Q5 and Q7 under QK_KERNEL_STRATEGY=shuffle=compacted and Q3 under
     a masked-split cap of 2^20 (the compacted split, K17; one counts read
     per compacted split, none on any other path), bench.py's skew join
     (300,000 build rows, 90% on one key, 8,192-row batches, QK_SKEW_RATIO
     1.5, QK_ADAPT_MIN_ROWS 20000) adaptive (the trigger fires once: K26
     salts the build, replicates the probe) and with QK_ADAPT=0, and Q1, Q4
     and Q5 under groupby=sort (the one-hot partial aggregate K6 where its
     512 MiB gate admits a batch, the sort group-by elsewhere), with every
     kernel's launch count set to 0 just before each path and read just
     after, and check each result against a numpy oracle; run each again
     warm.  Every batch of every path lands through the narrowed wire and
     one K23 decode: it fails unless K23 launched once per landed batch,
     unless every kernel's devprof dispatches on the path equal its
     launches, unless K8's launches equal the path's compacting concats
     (one a 16 columns) with no torch.nonzero inside them, unless every
     dense rank (K10) and many-to-many plan (K13p) launched one radix sort
     of csrc/sort.cuh and called no lexsort_perm or torch.sort (on every
     engine and mesh path), unless K10 and K13p launched on Q4, Q13 and
     Q21, when a path but
     the gramian, covariance and quantile ones launched no K8, when K2's
     Triton pre-pass did not run once a K2 call on Q1
     and Q5 (their plans have expression inputs) or ran at all elsewhere
     (the as-of paths' plan is plain columns and count(*)), or when Q1's
     wire bytes exceed half its logical bytes; it
     prints each path's landed batches, wire and logical bytes and host
     encode seconds per batch;
  4b. the mesh plane: Q1, Q3, Q5, dryrun_multichip's two shapes
     (scan -> filter -> join -> join -> group-by over the TPC-H tables; the
     as-of join by symbol then a group-by over the ticks) and the seven
     tick paths (both as-of directions, tumbling, hopping, session and
     sliding windows, shift) through QuokkaContext(mesh=make_mesh(8)),
     eight shards on the card, each against its numpy oracle; it fails on
     a fallback to the engine, a per-step batch, K24 or K8 not launched, K14 not
     launched on a path with a PK join, a kernel the mesh does not run, a
     dense rank without its one radix sort or with a lexsort_perm or
     torch.sort inside it, or launches that differ from devprof's
     dispatches or (K23) from the landed batches; it prints cold and warm walls beside the engine's for
     the same query, peak device memory, device busy time, idle share, D2H
     copies, cudaStreamSynchronize calls and the device time of the top
     kernels;
  5. where the time goes: a warm run of each query with the engine's host
     steps timed, and one under the profiler (device busy, idle share of
     the warm wall, device time per kernel, D2H copies and
     cudaStreamSynchronize calls).  With --parent DIR (another checkout's
     root, e.g. the parent commit unpacked with git archive), Q1, Q3 and Q5
     run through that tree and this one in turns (parent, change, change,
     parent; ``--walls-only`` subprocesses): warm walls, read + bridge,
     idle share, and the D2H copies and stream syncs, which must equal the
     parent's once the ledger's own batched count reads are taken off.
     Then devprof's calibration (row 25: the reference's 256^3 float32
     matmul and 2^21-element add) beside the data sheet, and EXPLAIN
     ANALYZE of Q1 and Q5 with its device-efficiency section;
  6. hold each kernel against its plain torch version on the card, at the
     shapes the query runs gave it (K1 at Q1's; K2 at Q1's and at the
     forward as-of's largest call, 129 buckets, each also for the same
     bits in a second launch, beside one index_add_ of its stacked float64
     inputs, a yardstick of the sums only; K2's pre-pass alone at Q1's;
     K3 at Q1's, Q3's,
     tumbling's and hopping's, each call under torch.cuda's sync debug
     mode, so that a host read in a call fails; K4 at Q1's and Q3's; K5, K11,
     K12 at Q3's, K12 also on float64 keys with -0.0 and NaN; K13 at
     Q13's and with one probe key matching 10^4 build rows;
     K10 and K13p (both modes) at Q4's, Q13's and Q21's largest plans, at
     that skewed case and on float64 limbs with -0.0 and NaN, float32 and
     bool limbs, all rows invalid, no valid build row, row counts that are
     not a multiple of the tile and strided inputs, bit for bit, and the
     radix sort under them (csrc/sort.cuh) index for index against its
     plain version at the three plans, on a key of two words and on float
     limbs; each timed whole and by part (range and pack passes, digit
     passes, rank pass, fill), beside a stable torch.sort of the packed key;
     K16 at Q7's, also with dates before 1970 and nulls; K18 at the
     asof's, K19 at the sort strategy's, sliding's and shift's, and K19's
     segment bounds (its scan both ways) at sliding's and shift's, beside
     one torch.cummax (the start half) and row 20's flip and cummin (the
     end half), K20a and K20b at sliding's, each also on one symbol
     holding every quote,
     whole-second timestamps, 2^23 rows and empty or all-invalid sides,
     K20b also on random and degenerate ranges with NaN in x and on one
     window over all rows, at 2^20 rows,
     K18 also with every quote its own key, 20,000 keys (past its
     shared-memory stage of the run table), no key limb, float64 times
     with NaN and -0.0, int32 and float32 times, and on every path K18's
     and K12's launches must take the typed search, not the
     runtime-dispatch kernel;
     K21 at the vector query's shape and at 256 queries, k = 1, 10, 100,
     d = 1, 7, 100, 768 with invalid and null rows, merged again into its
     own result, and 50 rows at k = 100; K22 at the gramian's shape and at
     d = 1, 4, 17, 64; K17 at Q3 compacted's largest split, also at 64
     parts, with empty parts and all rows invalid, and at 2^24 + 3 rows
     with 1, 2 and 64 parts and ids out of range; K8 at Q3's largest
     compacting concat and on part lengths that are not multiples of 4096,
     one part of 2^24 rows, more columns than a launch takes, dtypes that
     differ between parts, strided sources and empty and all-invalid
     parts, each through concat_batches and bit for bit; K26 at the skew join's
     and Q3's largest splits in both modes; K6 at Q1 sort's largest call;
     K23 at Q1's and Q3's largest landed batches and on NaN / -0.0
     dictionaries, uint16 codes, a plan that widens then degrades, an
     all-pass layout and a 0-row batch, bit for bit; K24 at the mesh Q3's
     largest shuffle and at 1, 2, 8 and 64 shards, with every leaf width,
     no valid row, one bucket holding every row and float key limbs
     holding NaN and -0.0, bit for bit; K14 at the mesh Q3's and Q5's
     largest calls, with duplicate build keys, no matches and no valid
     row),
     and time kernel, plain version and bound with CUDA events; the
     torch-primitive rows 7, 9, 14, 15, 20 and `_mask_and_count`
     (kernels.apply_mask) are timed too;
  7. print one JSON line of per-kernel numbers, the card line, and last the
     contract line {"ok": true, "device": {...}}.

Details of the run go to chiprun_out/chip_smoke.json.  The script imports
neither JAX nor quokka_tpu; pyarrow only for the vector tier, whose inputs
are an Arrow table and a Parquet file.  It exits non-zero without
printing a result when no CUDA device is available or when it runs outside
a checkout that holds quokka_tpu_torch/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHIP_CUTOFF = "1998-12-01"
Q1_FILTER = "l_shipdate <= date '1998-12-01' - interval '90' day"
Q1_AGGS = ("sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price, "
           "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
           "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
           "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
           "avg(l_discount) as avg_disc, count(*) as count_order")
REV = "sum(l_extendedprice * (1 - l_discount)) as revenue"
Q3_DATE = "1995-03-15"
BATCH_ROWS = 1 << 20

RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
ORDER_STATUS = ["F", "O", "P"]
BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
# o_comment: "special requests" (code 0) with probability 0.05, else one of
# this many distinct comments
COMMENT_POOL = 10_000
Q19_FILTER = (
    "(p_brand = 'Brand#12' and l_quantity >= 1 and l_quantity <= 11 "
    " and p_size between 1 and 5) "
    "or (p_brand = 'Brand#23' and l_quantity >= 10 and l_quantity <= 20 "
    " and p_size between 1 and 10) "
    "or (p_brand = 'Brand#34' and l_quantity >= 20 and l_quantity <= 30 "
    " and p_size between 1 and 15)")
Q7_FILTER = ("(supp_nation = 'FRANCE' and cust_nation = 'GERMANY') or "
             "(supp_nation = 'GERMANY' and cust_nation = 'FRANCE')")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def days(iso: str) -> int:
    import numpy as np

    return int((np.datetime64(iso, "D") - np.datetime64("1970-01-01", "D")).astype(int))


# ---------------------------------------------------------------------------
# data: TPC-H tables with the domains of tests/tpch_data.py, in numpy
# ---------------------------------------------------------------------------


class Table:
    """numpy columns of one table: string columns as int32 codes into a
    dictionary, date columns as int32 days."""

    def __init__(self, cols, dicts=None, dates=()):
        import numpy as np

        self.cols = cols
        self.dicts = {k: np.array(v, dtype=object) for k, v in (dicts or {}).items()}
        self.dates = set(dates)

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.cols.values())))


def make_tpch(sf: float, seed: int):
    """The seven tables Q1, Q3, Q5, Q4, Q13, Q19, Q7 and Q21 read: orders have
    keys 4, 8, 12, ...; customers whose key is a multiple of 3 place no
    orders; 1-7 lines per order; ship date = order date + 1..121 days,
    commit date = order date + 30..90, receipt date = ship date + 1..30;
    brands Brand#MN (M, N in 1..5), part sizes 1..50."""
    import numpy as np

    r = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 50)
    n_cust = max(int(150_000 * sf), 20)
    n_part = max(int(200_000 * sf), 25)
    n_supp = max(int(10_000 * sf), 10)
    i64 = np.int64
    region = Table({"r_regionkey": np.arange(5, dtype=i64),
                    "r_name": np.arange(5, dtype=np.int32)}, {"r_name": REGIONS})
    nation = Table({"n_nationkey": np.arange(25, dtype=i64),
                    "n_name": np.arange(25, dtype=np.int32),
                    "n_regionkey": np.array([g for _, g in NATIONS], dtype=i64)},
                   {"n_name": [n for n, _ in NATIONS]})
    supplier = Table({"s_suppkey": np.arange(1, n_supp + 1, dtype=i64),
                      "s_nationkey": r.integers(0, 25, n_supp).astype(i64)})
    custkey = np.arange(1, n_cust + 1, dtype=i64)
    customer = Table({"c_custkey": custkey,
                      "c_nationkey": r.integers(0, 25, n_cust).astype(i64),
                      "c_mktsegment": r.integers(0, 5, n_cust).astype(np.int32)},
                     {"c_mktsegment": SEGMENTS})
    odate = r.integers(days("1992-01-01"), days("1998-08-02"), n_orders).astype(np.int32)
    with_orders = custkey[custkey % 3 != 0]
    okey = np.arange(1, n_orders + 1, dtype=i64) * 4
    part = Table({"p_partkey": np.arange(1, n_part + 1, dtype=i64),
                  "p_brand": r.integers(0, len(BRANDS), n_part).astype(np.int32),
                  "p_size": r.integers(1, 51, n_part).astype(i64)}, {"p_brand": BRANDS})
    comment = np.where(r.random(n_orders) < 0.05, 0,
                       1 + r.integers(0, COMMENT_POOL, n_orders)).astype(np.int32)
    orders = Table({"o_orderkey": okey,
                    "o_custkey": with_orders[r.integers(0, len(with_orders), n_orders)],
                    "o_orderdate": odate,
                    "o_orderpriority": r.integers(0, 5, n_orders).astype(np.int32),
                    "o_shippriority": np.zeros(n_orders, dtype=i64),
                    "o_comment": comment},
                   {"o_orderpriority": PRIORITIES,
                    "o_comment": ["special requests"]
                    + [f"order comment {k}" for k in range(COMMENT_POOL)]},
                   dates=["o_orderdate"])
    lines_per = r.integers(1, 8, n_orders)
    n = int(lines_per.sum())
    qty = r.integers(1, 51, n).astype(np.float64)
    lodate = np.repeat(odate, lines_per)
    ship = (lodate + r.integers(1, 122, n)).astype(np.int32)
    lineitem = Table({
        "l_orderkey": np.repeat(okey, lines_per),
        "l_partkey": r.integers(1, n_part + 1, n).astype(i64),
        "l_suppkey": r.integers(1, n_supp + 1, n).astype(i64),
        "l_quantity": qty,
        "l_extendedprice": np.round(qty * (900 + r.uniform(0, 1200, n)) / 10, 2),
        "l_discount": np.round(r.uniform(0, 0.1, n), 2),
        "l_tax": np.round(r.uniform(0, 0.08, n), 2),
        "l_returnflag": r.integers(0, 3, n).astype(np.int32),
        "l_linestatus": r.integers(0, 2, n).astype(np.int32),
        "l_shipdate": ship,
        "l_commitdate": (lodate + r.integers(30, 91, n)).astype(np.int32),
        "l_receiptdate": (ship + r.integers(1, 31, n)).astype(np.int32),
    }, {"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUS},
        dates=["l_shipdate", "l_commitdate", "l_receiptdate"])
    # Q21's columns, made from the draws above (no draw of their own, so the
    # other tables stay as they were): an order is 'F' when every line
    # shipped by 1995-06-17, 'O' when none did, else 'P' (TPC-H's rule)
    first = np.concatenate([[0], np.cumsum(lines_per)[:-1]])
    cut = days("1995-06-17")
    shipped = np.add.reduceat((ship <= cut).astype(np.int64), first)
    orders.cols["o_orderstatus"] = np.where(shipped == lines_per, 0,
                                            np.where(shipped == 0, 1, 2)).astype(np.int32)
    orders.dicts["o_orderstatus"] = np.array(ORDER_STATUS, dtype=object)
    supplier.cols["s_name"] = np.arange(n_supp, dtype=np.int32)
    supplier.dicts["s_name"] = np.array([f"Supplier#{k:09d}" for k in range(1, n_supp + 1)],
                                        dtype=object)
    return {"region": region, "nation": nation, "supplier": supplier, "part": part,
            "customer": customer, "orders": orders, "lineitem": lineitem}


class TableReader:
    """Reader over a Table: 2^20-row slices (``batch_rows``) dealt round-robin to the
    channels, delivered as HostTables (no Arrow) of the plan's columns
    (``columns``, which the source sets from its pushed-down projection);
    ``num_rows`` and ``sample`` feed the optimizer's catalog."""

    def __init__(self, table: Table, batch_rows: int = 0):
        self.table = table
        self.num_rows = table.num_rows
        self.columns = None
        self.batch_rows = batch_rows or BATCH_ROWS

    @property
    def schema(self):
        return list(self.table.cols)

    def get_own_state(self, num_channels):
        n = self.num_rows
        step = self.batch_rows
        slices = [(s, min(step, n - s)) for s in range(0, n, step)] or [(0, 0)]
        return {ch: slices[ch::num_channels] for ch in range(num_channels)}

    def execute(self, channel, lineage):
        from quokka_tpu_torch.ops.bridge import HostTable

        start, length = lineage
        t = self.table
        cols = {}
        for k in self.columns or list(t.cols):
            v = t.cols[k][start:start + length]
            cols[k] = v.astype("datetime64[D]") if k in t.dates else v
        return HostTable(cols, dictionaries={k: v for k, v in t.dicts.items() if k in cols})

    def sample(self, rows):
        return self.execute(0, (0, min(rows, self.num_rows)))


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------


def q1_oracle(li: Table):
    """{(flag, status): {column: value}}."""
    import numpy as np

    cols = li.cols
    m = cols["l_shipdate"] <= days(SHIP_CUTOFF) - 90
    gid = (cols["l_returnflag"] * 2 + cols["l_linestatus"])[m]
    q, p = cols["l_quantity"][m], cols["l_extendedprice"][m]
    d, t = cols["l_discount"][m], cols["l_tax"][m]
    cnt = np.bincount(gid, minlength=6)
    sums = {
        "sum_qty": np.bincount(gid, q, 6), "sum_base_price": np.bincount(gid, p, 6),
        "sum_disc_price": np.bincount(gid, p * (1 - d), 6),
        "sum_charge": np.bincount(gid, p * (1 - d) * (1 + t), 6),
    }
    out = {}
    for g in range(6):
        if cnt[g] == 0:
            continue
        row = {k: float(v[g]) for k, v in sums.items()}
        row.update(avg_qty=row["sum_qty"] / cnt[g], avg_price=row["sum_base_price"] / cnt[g],
                   avg_disc=float(np.bincount(gid, d, 6)[g]) / cnt[g], count_order=int(cnt[g]))
        out[(RETURNFLAGS[g // 2], LINESTATUS[g % 2])] = row
    return out


def check_q1(got, exp) -> None:
    import numpy as np

    keys = list(zip(got["l_returnflag"].tolist(), got["l_linestatus"].tolist()))
    if sorted(keys) != sorted(exp):
        fail(f"Q1 groups {sorted(keys)} != oracle {sorted(exp)}")
    for i, key in enumerate(keys):
        for col, want in exp[key].items():
            have = got[col][i]
            if col in ("count_order", "sum_qty"):
                if have != want:
                    fail(f"Q1 {key} {col}: {have} != {want} (exact)")
            elif not np.isclose(have, want, rtol=1e-9, atol=0):
                fail(f"Q1 {key} {col}: {have} vs {want} beyond rtol 1e-9")


def _pk_lookup(keys, probe):
    """Index of each probe value in the sorted unique ``keys`` and whether
    it is there (a join by searchsorted)."""
    import numpy as np

    idx = np.searchsorted(keys, probe)
    idx_c = np.minimum(idx, max(len(keys) - 1, 0))
    return idx_c, (idx < len(keys)) & (keys[idx_c] == probe)


def q3_oracle(t):
    """The top 10 (l_orderkey, o_orderdate, o_shippriority, revenue)."""
    import numpy as np

    d = days(Q3_DATE)
    li, o, c = t["lineitem"].cols, t["orders"].cols, t["customer"].cols
    lm = li["l_shipdate"] > d
    om = o["o_orderdate"] < d
    cm = c["c_mktsegment"] == SEGMENTS.index("BUILDING")
    ok = o["o_orderkey"][om]
    oi, hit = _pk_lookup(ok, li["l_orderkey"])
    sel = lm & hit
    cust = o["o_custkey"][om][oi[sel]]
    ci, chit = _pk_lookup(c["c_custkey"][cm], cust)
    rows = np.nonzero(sel)[0][chit]
    rev = li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])
    keys, inv = np.unique(li["l_orderkey"][rows], return_inverse=True)
    sums = np.bincount(inv, rev, len(keys))
    top = np.argsort(-sums, kind="stable")[:10]
    oj, _ = _pk_lookup(o["o_orderkey"], keys[top])
    return {"l_orderkey": keys[top], "o_orderdate": o["o_orderdate"][oj],
            "o_shippriority": o["o_shippriority"][oj], "revenue": sums[top]}


def check_q3(got, exp) -> None:
    import numpy as np

    if len(got["revenue"]) != len(exp["revenue"]):
        fail(f"Q3 returned {len(got['revenue'])} rows, the oracle {len(exp['revenue'])}")
    order = np.argsort(-got["revenue"], kind="stable")
    gdays = (got["o_orderdate"][order].astype("datetime64[D]")
             - np.datetime64("1970-01-01", "D")).astype(np.int64)
    if not (np.array_equal(got["l_orderkey"][order], exp["l_orderkey"])
            and np.array_equal(gdays, exp["o_orderdate"])
            and np.array_equal(got["o_shippriority"][order], exp["o_shippriority"])):
        fail(f"Q3 top-10 keys {got['l_orderkey'][order].tolist()} != oracle "
             f"{exp['l_orderkey'].tolist()}")
    if not np.allclose(got["revenue"][order], exp["revenue"], rtol=1e-9, atol=0):
        fail("Q3 revenue beyond rtol 1e-9 of the oracle")


def q5_oracle(t):
    """{n_name: revenue} for the ASIA nations, orders of 1994."""
    import numpy as np

    li, o, c = t["lineitem"].cols, t["orders"].cols, t["customer"].cols
    s, nat = t["supplier"].cols, t["nation"].cols
    om = (o["o_orderdate"] >= days("1994-01-01")) & (o["o_orderdate"] < days("1995-01-01"))
    oi, hit = _pk_lookup(o["o_orderkey"][om], li["l_orderkey"])
    rows = np.nonzero(hit)[0]
    cust = o["o_custkey"][om][oi[rows]]
    ci, chit = _pk_lookup(c["c_custkey"], cust)
    rows, ci = rows[chit], ci[chit]
    cnat = c["c_nationkey"][ci]
    si, shit = _pk_lookup(s["s_suppkey"], li["l_suppkey"][rows])
    keep = shit & (s["s_nationkey"][si] == cnat)
    rows, cnat = rows[keep], cnat[keep]
    asia = nat["n_regionkey"][cnat] == REGIONS.index("ASIA")
    rows, cnat = rows[asia], cnat[asia]
    rev = li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])
    sums = np.bincount(cnat, rev, 25)
    return {NATIONS[k][0]: float(sums[k]) for k in np.unique(cnat)}


def check_q5(got, exp) -> None:
    import numpy as np

    names = list(got["n_name"])
    if sorted(names) != sorted(exp):
        fail(f"Q5 nations {sorted(names)} != oracle {sorted(exp)}")
    for name, rev in zip(names, got["revenue"]):
        if not np.isclose(rev, exp[name], rtol=1e-9, atol=0):
            fail(f"Q5 {name} revenue {rev} vs {exp[name]} beyond rtol 1e-9")


def q4_oracle(t):
    """{o_orderpriority: order_count} of Q3 1993's orders with a late line."""
    import numpy as np

    o, li = t["orders"].cols, t["lineitem"].cols
    om = (o["o_orderdate"] >= days("1993-07-01")) & (o["o_orderdate"] < days("1993-10-01"))
    late = np.unique(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])
    cnt = np.bincount(o["o_orderpriority"][om & np.isin(o["o_orderkey"], late)], minlength=5)
    return {PRIORITIES[i]: int(c) for i, c in enumerate(cnt) if c}


def q13_oracle(t):
    """{c_count: custdist}: customers by their number of orders without
    "special" in the comment (0 for customers without orders)."""
    import numpy as np

    c, o = t["customer"].cols, t["orders"].cols
    plain = o["o_comment"] != 0
    per = np.bincount(o["o_custkey"][plain], minlength=len(c["c_custkey"]) + 1)[c["c_custkey"]]
    return {k: int(v) for k, v in enumerate(np.bincount(per)) if v}


def q19_oracle(t):
    """(revenue, n) of the lines whose part meets one of the three brand /
    quantity / size conditions."""
    li, p = t["lineitem"].cols, t["part"].cols
    pi = li["l_partkey"] - 1
    brand, size, q = p["p_brand"][pi], p["p_size"][pi], li["l_quantity"]
    cond = False
    for b, lo, hi, smax in (("Brand#12", 1, 11, 5), ("Brand#23", 10, 20, 10),
                            ("Brand#34", 20, 30, 15)):
        cond = cond | ((brand == BRANDS.index(b)) & (q >= lo) & (q <= hi)
                       & (size >= 1) & (size <= smax))
    rev = li["l_extendedprice"][cond] * (1 - li["l_discount"][cond])
    return float(rev.sum()), int(cond.sum())


def q7_oracle(t):
    """{(supp_nation, cust_nation, l_year): revenue} of 1995-1996's lines
    shipped between France and Germany."""
    import numpy as np

    li, s, o, c = (t[k].cols for k in ("lineitem", "supplier", "orders", "customer"))
    names = [n for n, _ in NATIONS]
    sd = li["l_shipdate"]
    snat = s["s_nationkey"][li["l_suppkey"] - 1]
    cnat = c["c_nationkey"][o["o_custkey"][li["l_orderkey"] // 4 - 1] - 1]
    fr, de = names.index("FRANCE"), names.index("GERMANY")
    sel = ((sd >= days("1995-01-01")) & (sd <= days("1996-12-31"))
           & (((snat == fr) & (cnat == de)) | ((snat == de) & (cnat == fr))))
    year = sd[sel].astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    vol = li["l_extendedprice"][sel] * (1 - li["l_discount"][sel])
    out = {}
    for a, b, y, v in zip(snat[sel], cnat[sel], year, vol):
        key = (names[a], names[b], int(y))
        out[key] = out.get(key, 0.0) + float(v)
    return out


def check_groups(what, got, keys, value, exp, exact) -> None:
    """Compare a grouped result with a {key tuple (or key): value} oracle:
    the same groups, values exact or to rtol 1e-9."""
    import numpy as np

    cols = [got[k].tolist() for k in keys]
    rows = list(zip(*cols))
    if len(keys) == 1:
        rows = [r[0] for r in rows]
    if sorted(rows) != sorted(exp):
        fail(f"{what} groups {sorted(rows)[:8]}... != oracle {sorted(exp)[:8]}...")
    for row, have in zip(rows, got[value].tolist()):
        want = exp[row]
        if exact and have != want:
            fail(f"{what} {row} {value}: {have} != {want} (exact)")
        if not exact and not np.isclose(have, want, rtol=1e-9, atol=0):
            fail(f"{what} {row} {value}: {have} vs {want} beyond rtol 1e-9")


def check_q4(got, exp) -> None:
    check_groups("Q4", got, ["o_orderpriority"], "order_count", exp, exact=True)


def check_q13(got, exp) -> None:
    check_groups("Q13", got, ["c_count"], "custdist", exp, exact=True)


def check_q19(got, exp) -> None:
    import numpy as np

    rev, n = exp
    if int(got["n"][0]) != n or n == 0:
        fail(f"Q19 count {int(got['n'][0])} != oracle {n}")
    if not np.isclose(got["revenue"][0], rev, rtol=1e-9, atol=0):
        fail(f"Q19 revenue {got['revenue'][0]} vs {rev} beyond rtol 1e-9")


def check_q7(got, exp) -> None:
    check_groups("Q7", got, ["supp_nation", "cust_nation", "l_year"], "revenue", exp,
                 exact=False)


def q21_nation(t) -> str:
    """Q21's nation: the modal supplier nation (tests/test_tpch2.py's rule;
    the spec names SAUDI ARABIA)."""
    import numpy as np

    return NATIONS[int(np.bincount(t["supplier"].cols["s_nationkey"], minlength=25).argmax())][0]


def q21_oracle(t):
    """{s_name: numwait}: the distinct (order, supplier) pairs of late lines
    (receipt after commit) of 'F' orders with more than one supplier and
    exactly one late supplier, whose supplier is of Q21's nation."""
    import numpy as np

    li, o, s = t["lineitem"].cols, t["orders"].cols, t["supplier"].cols
    width = int(s["s_suppkey"].max()) + 1
    pair = li["l_orderkey"] * width + li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    every, lpairs = np.unique(pair), np.unique(pair[late])
    order_of = every // width
    n_supp = dict(zip(*np.unique(order_of, return_counts=True)))
    lo, ls = lpairs // width, lpairs % width
    lorders, lcounts = np.unique(lo, return_counts=True)
    n_late = dict(zip(lorders, lcounts))
    status_f = o["o_orderstatus"][lo // 4 - 1] == ORDER_STATUS.index("F")
    nat = [n for n, _ in NATIONS].index(q21_nation(t))
    keep = status_f & (s["s_nationkey"][ls - 1] == nat) & np.array(
        [n_supp[x] > 1 and n_late[x] == 1 for x in lo.tolist()], dtype=bool)
    names = t["supplier"].dicts["s_name"][s["s_name"][ls[keep] - 1]]
    got, cnt = np.unique(names.astype(str), return_counts=True)
    return {str(a): int(c) for a, c in zip(got, cnt)}


def check_q21(got, exp) -> None:
    if not exp:
        fail("Q21: the oracle's result is empty")
    check_groups("Q21", got, ["s_name"], "numwait", exp, exact=True)


# ---------------------------------------------------------------------------
# the time-series tier: bench.py's tick backtest (bench.py:61-104, 253)
# ---------------------------------------------------------------------------

TS_SYMBOLS = 100
TS_SPAN = 86_400_000  # one trading day in ms
TS_SYMS = [f"S{i:03d}" for i in range(TS_SYMBOLS)]
TS_TUMBLE, TS_HOP, TS_GAP, TS_SLIDE = 60_000, 15_000, 5_000, 10_000


def make_ticks(sf: float, seed: int):
    """bench.py's trades (1.15M at SF1) and quotes (6M), from seeds 7 and 8
    (plus --seed): int64 ms times sorted over one day, 100 symbols S000-S099
    (int32 codes), trade sizes 1-499, bids 10-500 rounded to 3 places."""
    import numpy as np

    out = {}
    for name, n, s in (("trades", int(1_150_000 * sf), 7), ("quotes", int(6_000_000 * sf), 8)):
        r = np.random.default_rng(s + seed)
        cols = {"time": np.sort(r.integers(0, TS_SPAN, n)).astype(np.int64),
                "symbol": r.integers(0, TS_SYMBOLS, n).astype(np.int32)}
        if name == "trades":
            cols["size"] = r.integers(1, 500, n).astype(np.int64)
        else:
            cols["bid"] = r.uniform(10, 500, n).round(3)
        out[name] = cols
    return out


def _sym_key(sym, t):
    """One int64 that orders rows by (symbol, time)."""
    import numpy as np

    return (sym.astype(np.int64) << 40) | t


def _by_symbol(cols):
    """The rows' order by (symbol, time), ties in row order (stable)."""
    import numpy as np

    return np.lexsort((cols["time"], cols["symbol"]))


def asof_oracle(ticks, direction, value="notional"):
    """{symbol: (sum of bid * size, matched trades)} of the as-of backtest,
    by a per-symbol np.searchsorted: backward takes the last quote with time
    <= t (the last of tied quotes), forward the first with time >= t.  With
    ``value="size"`` the sums are of the trade sizes (dryrun_multichip's
    as-of shape)."""
    import numpy as np

    tr, qu = ticks["trades"], ticks["quotes"]
    qo = _by_symbol(qu)
    qsym, qkey = qu["symbol"][qo], _sym_key(qu["symbol"][qo], qu["time"][qo])
    tkey = _sym_key(tr["symbol"], tr["time"])
    if direction == "backward":
        pos = np.searchsorted(qkey, tkey, side="right") - 1
    else:
        pos = np.searchsorted(qkey, tkey, side="left")
    ok = (pos >= 0) & (pos < len(qkey))
    posc = np.clip(pos, 0, max(len(qkey) - 1, 0))
    ok &= qsym[posc] == tr["symbol"]
    v = qu["bid"][qo][posc] * tr["size"] if value == "notional" else tr["size"]
    total = np.bincount(tr["symbol"][ok], v[ok], TS_SYMBOLS)
    n = np.bincount(tr["symbol"][ok], minlength=TS_SYMBOLS)
    return {TS_SYMS[k]: (float(total[k]), int(n[k])) for k in range(TS_SYMBOLS) if n[k]}


def check_asof(got, exp) -> None:
    import numpy as np

    syms = list(got["symbol"])
    if sorted(syms) != sorted(exp):
        fail(f"asof symbols {sorted(syms)[:5]}... != oracle {sorted(exp)[:5]}...")
    for s, total, n in zip(syms, got["total"], got["n"]):
        if int(n) != exp[s][1]:
            fail(f"asof {s}: {int(n)} matched trades != {exp[s][1]} (exact)")
        if not np.isclose(total, exp[s][0], rtol=1e-9, atol=0):
            fail(f"asof {s}: total {total} vs {exp[s][0]} beyond rtol 1e-9")


def _codes(symbols):
    import numpy as np

    return np.searchsorted(np.array(TS_SYMS), np.asarray(symbols).astype("U4")).astype(np.int64)


def window_oracles(ticks):
    """Numpy oracles of the window and shift phases over the quotes: each
    symbol's rows sorted by time (ties in row order), then direct sums,
    counts, min / max and lags."""
    import numpy as np

    qu = ticks["quotes"]
    qo = _by_symbol(qu)
    sym, t, bid = qu["symbol"][qo].astype(np.int64), qu["time"][qo], qu["bid"][qo]
    out = {}
    # tumbling: sum, count, avg per (symbol, minute)
    key = sym * (TS_SPAN // TS_TUMBLE + 1) + t // TS_TUMBLE
    uk, inv = np.unique(key, return_inverse=True)
    s, n = np.bincount(inv, bid), np.bincount(inv)
    out["tumbling"] = {"key": uk, "s": s, "n": n, "a": s / n}
    # hopping: every row counts in size / hop windows
    wids = [t // TS_HOP - j for j in range(TS_TUMBLE // TS_HOP)]
    hk = np.concatenate([sym[w >= 0] * (TS_SPAN // TS_HOP + 1) + w[w >= 0] for w in wids])
    uk, cnt = np.unique(hk, return_counts=True)
    out["hopping"] = {"key": uk, "n": cnt}
    # session: a gap of more than TS_GAP ms opens a new session
    first = np.r_[True, (sym[1:] != sym[:-1]) | (t[1:] - t[:-1] > TS_GAP)]
    sid = np.cumsum(first) - 1
    last = np.r_[first[1:], True]
    out["session"] = {"sym": sym[first], "start": t[first], "end": t[last],
                      "s": np.bincount(sid, bid), "n": np.bincount(sid)}
    # sliding: rows of the symbol with time in [t - TS_SLIDE, t], summed
    # directly row by row (no prefix sums)
    k = _sym_key(sym, t)
    left = np.searchsorted(k, _sym_key(sym, np.maximum(t - TS_SLIDE, 0)), side="left")
    right = np.searchsorted(k, k, side="right") - 1
    w = right - left + 1
    tot = np.zeros(len(t))
    lo, hi = bid.copy(), bid.copy()
    for j in range(int(w.max()) if len(w) else 0):
        v = bid[np.minimum(left + j, right)]
        tot += np.where(j < w, v, 0.0)
        lo, hi = np.minimum(lo, v), np.maximum(hi, v)
    out["sliding"] = {"sym": sym, "t": t, "bid": bid, "n": w, "a": tot / w, "lo": lo,
                      "hi": hi, "bid_total": float(bid.sum())}
    # shift: the previous row of the symbol, null (NaN) on its first row
    prev = np.r_[np.nan, bid[:-1]]
    out["shift"] = {"sym": sym, "t": t, "bid": bid,
                    "lag": np.where(np.r_[True, sym[1:] != sym[:-1]], np.nan, prev)}
    return out


def _grouped(what, got_key, exp_key):
    import numpy as np

    order = np.argsort(got_key, kind="stable")
    if not np.array_equal(got_key[order], exp_key):
        fail(f"{what}: {len(got_key)} groups differ from the oracle's {len(exp_key)}")
    return order


def check_tumbling(got, exp) -> None:
    import numpy as np

    ws = got["window_start"]
    order = _grouped("tumbling", _codes(got["symbol"]) * (TS_SPAN // TS_TUMBLE + 1)
                     + ws // TS_TUMBLE, exp["key"])
    if not np.array_equal(got["window_end"] - ws, np.full(len(ws), TS_TUMBLE)):
        fail("tumbling: window_end != window_start + size")
    if not np.array_equal(got["n"][order], exp["n"]):
        fail("tumbling: counts differ from the oracle (exact)")
    for c in ("s", "a"):
        if not np.allclose(got[c][order], exp[c], rtol=1e-9, atol=0):
            fail(f"tumbling: {c} beyond rtol 1e-9 of the oracle")


def check_hopping(got, exp) -> None:
    import numpy as np

    order = _grouped("hopping", _codes(got["symbol"]) * (TS_SPAN // TS_HOP + 1)
                     + got["window_start"] // TS_HOP, exp["key"])
    if not np.array_equal(got["n"][order], exp["n"]):
        fail("hopping: counts differ from the oracle (exact)")


def check_session(got, exp) -> None:
    import numpy as np

    codes = _codes(got["symbol"])
    order = np.lexsort((got["session_start"], codes))
    if not (np.array_equal(codes[order], exp["sym"])
            and np.array_equal(got["session_start"][order], exp["start"])
            and np.array_equal(got["session_end"][order], exp["end"])
            and np.array_equal(got["n"][order], exp["n"])):
        fail(f"session: {len(codes)} sessions' keys, bounds or counts differ from the "
             f"oracle's {len(exp['sym'])} (exact)")
    if not np.allclose(got["s"][order], exp["s"], rtol=1e-9, atol=0):
        fail("session: sums beyond rtol 1e-9 of the oracle")


def _rows(what, got, exp, extra):
    """Align a per-row result with the oracle's rows by (symbol, time, bid,
    extra) and check those columns exactly."""
    import numpy as np

    codes = _codes(got["symbol"])
    go = np.lexsort((got[extra[0]], got["bid"], got["time"], codes))
    eo = np.lexsort((exp[extra[1]], exp["bid"], exp["t"], exp["sym"]))
    if not (len(go) == len(eo) and np.array_equal(codes[go], exp["sym"][eo])
            and np.array_equal(got["time"][go], exp["t"][eo])
            and np.array_equal(got["bid"][go], exp["bid"][eo])):
        fail(f"{what}: {len(go)} rows differ from the oracle's {len(eo)} rows")
    return go, eo


def sliding_atol(exp):
    """Per-row absolute tolerance of the sliding average.  Its sum is
    c[r] - c[l-1], two prefixes of one `torch.cumsum` over a channel's merged
    batch (n <= 2^21 rows, every prefix at most M, the batch's total).  A
    parallel scan computes each prefix by its own tree of adds; with at most
    D roundings on any path, a prefix of nonnegative terms is within
    D * u * M of the true one (u = 2^-53), and the difference adds one more
    rounding, so |sum error| <= (2D + 1) * u * M, with D = ceil(log2 n) = 21
    for a tree scan.  M is not known here: the check uses P, the sum of
    every bid, which bounds it (P = 1.5e9 at SF1, about 5.7 M for 2^20-row
    batches); torch's CUDA scan (a single-pass look-back) can chain more
    roundings across its tiles than a tree does, and that slack covers
    prefixes up to about 120 roundings deep.  The average's atol is the
    sum's over w: about 7e-6 for a one-row window against bids of 10-500."""
    import numpy as np

    depth = 21  # ceil(log2(2^21)), the largest merged batch
    return (2 * depth + 1) * 2.0 ** -53 * exp["bid_total"] / exp["n"]


def check_sliding(got, exp) -> None:
    import numpy as np

    go, eo = _rows("sliding", got, exp, ("n", "n"))
    if not np.array_equal(got["n"][go], exp["n"][eo]):
        fail("sliding: window counts differ from the oracle (exact)")
    for c in ("lo", "hi"):
        if not np.array_equal(got[c][go], exp[c][eo]):
            fail(f"sliding: {c} differs from the oracle (exact)")
    a, b = got["a"][go], exp["a"][eo]
    bad = np.abs(a - b) > sliding_atol(exp)[eo] + 1e-9 * np.abs(b)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        fail(f"sliding: {int(bad.sum())} averages beyond rtol 1e-9 + the derived atol, "
             f"first {a[i]} vs {b[i]}")


def check_shift(got, exp) -> None:
    import numpy as np

    lag = got["bid_shifted_1"]
    go, eo = _rows("shift", got, exp, ("bid_shifted_1", "lag"))
    if not np.array_equal(lag[go], exp["lag"][eo], equal_nan=True):
        fail("shift: lagged bids differ from the oracle (exact, null where no history)")


SLIDING_AGGS = "avg(bid) as a, min(bid) as lo, max(bid) as hi, count(*) as n"


def tick_stream(name: str, ctx, ticks):
    """The time-series paths over the ticks through ``ctx``: the as-of
    backtest (bench.py:253; "asof forward" looks forward), the tumbling,
    hopping, session and sliding windows and the shift of the quotes, and
    dryrun_multichip's as-of shape ("asof shape").  Each source is sorted by
    time, in 2^20-row slices dealt to the channels in stride order."""
    import numpy as np

    from quokka_tpu_torch import windows
    from quokka_tpu_torch.dataset.ordered import InputSortedHostDataset
    from quokka_tpu_torch.ops import bridge

    def src(t):
        table = bridge.HostTable(dict(ticks[t]), dictionaries={
            "symbol": np.array(TS_SYMS, dtype=object)})
        return ctx.read_dataset(InputSortedHostDataset(table, "time", BATCH_ROWS),
                                sorted_by="time")

    if name in ("asof", "asof forward"):
        direction = "forward" if name == "asof forward" else "backward"
        return (src("trades").join_asof(src("quotes"), on="time", by="symbol",
                                        direction=direction)
                .with_columns_sql("bid * size as notional")
                .groupby("symbol").agg_sql("sum(notional) as total, count(*) as n"))
    if name == "asof shape":
        return (src("trades").join_asof(src("quotes"), on="time", by="symbol")
                .groupby("symbol").agg_sql("sum(size) as total, count(*) as n"))
    quotes = src("quotes")
    if name == "tumbling":
        return quotes.window_agg(windows.TumblingWindow(TS_TUMBLE),
                                 "sum(bid) as s, count(*) as n, avg(bid) as a", by="symbol")
    if name == "hopping":
        return quotes.window_agg(windows.HoppingWindow(TS_TUMBLE, TS_HOP), "count(*) as n",
                                 by="symbol")
    if name == "session":
        return quotes.window_agg(windows.SessionWindow(TS_GAP), "sum(bid) as s, count(*) as n",
                                 by="symbol")
    if name == "sliding":
        return quotes.window_agg(windows.SlidingWindow(TS_SLIDE), SLIDING_AGGS, by="symbol")
    if name == "shift":
        return quotes.shift("bid", n=1, by="symbol")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# the exchange tier: bench.py's skew join (bench.py:281-300, not cut)
# ---------------------------------------------------------------------------

SKEW_KEYS = 1_000
SKEW_FAT = 0.9
SKEW_BATCH = 1 << 13
# bench.py's settings for its adaptive-exchange scenario
SKEW_ENV = {"QK_SKEW_RATIO": "1.5", "QK_ADAPT_MIN_ROWS": "20000"}


def make_skewjoin(sf: float, seed: int):
    """bench.py's ``_skewjoin_paths`` data: a build side (k, v) of 300,000
    rows at SF1 whose keys are 1..999 but for 90% of rows on key 0, and a
    probe side (pk, g = pk % 50) of the 1,000 keys."""
    import numpy as np

    r = np.random.default_rng(seed)
    n = int(300_000 * max(sf, 0.1))
    keys = r.integers(1, SKEW_KEYS, n).astype(np.int64)
    keys[r.random(n) < SKEW_FAT] = 0
    return {"build": Table({"k": keys, "v": r.integers(0, 1000, n).astype(np.int64)}),
            "probe": Table({"pk": np.arange(SKEW_KEYS, dtype=np.int64),
                            "g": np.arange(SKEW_KEYS, dtype=np.int64) % 50})}


def skewjoin_oracle(t):
    """{g: (sum(v), count)}: every build key has exactly one probe row."""
    import numpy as np

    k, v = t["build"].cols["k"], t["build"].cols["v"]
    g = k % 50
    sv = np.zeros(50, dtype=np.int64)
    np.add.at(sv, g, v)
    n = np.bincount(g, minlength=50)
    return {int(i): (int(sv[i]), int(n[i])) for i in range(50) if n[i]}


def check_skewjoin(got, exp) -> None:
    check_groups("skewjoin", got, ["g"], "sv", {g: s for g, (s, _) in exp.items()},
                 exact=True)
    check_groups("skewjoin", got, ["g"], "n", {g: c for g, (_, c) in exp.items()},
                 exact=True)


# ---------------------------------------------------------------------------
# the vector, linear-algebra and quantile tier
# ---------------------------------------------------------------------------

# ann-benchmarks glove-100-angular's shape (cosine, 1,183,514 x 100, 10,000
# queries, k = 10); the vectors are made from --seed, not downloaded
VEC_ROWS, VEC_DIM, VEC_QUERIES, VEC_K = 1_183_514, 100, 10_000, 10
VEC_CENTRES, VEC_TOPICS, VEC_NULL_SHARE = 1000, 16, 1e-3
ANN_ROWS, ANN_ROW_GROUPS, ANN_CELLS, ANN_NPROBE, ANN_QUERIES = 1 << 18, 16, 32, 4, 4
LINALG_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax"]
QUANTILES = [0.01, 0.25, 0.5, 0.75, 0.99]
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
MATMUL_N_NOTE = ("the reference's 256^3 matmul and 2^21-element add are launch-sized on "
                 "this card")
VEC_SCORE_TOL, VEC_TIE_TOL = 2e-5, 4e-5


def make_vectors(sf: float, seed: int):
    """Clustered embeddings in numpy from --seed: 1,000 random centres, each
    a perturbed one of 16 topic directions, every vector a centre plus noise
    (cosine about 0.93 to its centre); 0.1% null rows; queries drawn the
    same way.  The ANN file's rows are ordered by topic, so that its row
    groups, like a real corpus appended over time, hold few topics each."""
    import numpy as np

    r = np.random.default_rng(seed + 100)
    topics = r.standard_normal((VEC_TOPICS, VEC_DIM), dtype=np.float32)
    topic_of = r.integers(0, VEC_TOPICS, VEC_CENTRES)
    centres = topics[topic_of] + 0.5 * r.standard_normal((VEC_CENTRES, VEC_DIM),
                                                         dtype=np.float32)

    def draw(n, by_topic=False):
        c = r.integers(0, VEC_CENTRES, n)
        if by_topic:
            c = c[np.argsort(topic_of[c], kind="stable")]
        v = centres[c] + 0.3 * r.standard_normal((n, VEC_DIM), dtype=np.float32)
        null = r.random(n) < VEC_NULL_SHARE
        v[null] = 0.0  # what a null row becomes on the device
        return v, null

    vecs, null = draw(max(int(VEC_ROWS * sf), 4096))
    ann, ann_null = draw(max(int(ANN_ROWS * sf) // ANN_ROW_GROUPS * ANN_ROW_GROUPS, 4096),
                         by_topic=True)
    queries = centres[r.integers(0, VEC_CENTRES, VEC_QUERIES)] + 0.3 * r.standard_normal(
        (VEC_QUERIES, VEC_DIM), dtype=np.float32)
    return {"vecs": vecs, "null": null, "ann": ann, "ann_null": ann_null, "queries": queries}


def vector_table(vecs, null):
    """The corpus as Arrow: id int64, emb fixed_size_list<float32, d>."""
    import numpy as np
    import pyarrow as pa

    emb = pa.FixedSizeListArray.from_arrays(pa.array(vecs.reshape(-1)), vecs.shape[1],
                                            mask=pa.array(null))
    return pa.table({"id": np.arange(len(vecs), dtype=np.int64), "emb": emb})


def _unit_f32(q):
    """The reference's query normalisation, in float32 on the host."""
    import numpy as np

    q = np.asarray(q, dtype=np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)


def topk_oracle(dev, vecs, queries, k, chunk=1 << 15):
    """Exact top-(k + 1) cosine scores and row ids per query, float64 on the
    card (oracle only): [Q, k + 1] scores and ids."""
    import torch

    q = torch.from_numpy(_unit_f32(queries)).to(dev, torch.float64)
    best_s = best_i = None
    for r0 in range(0, len(vecs), chunk):
        v = torch.from_numpy(vecs[r0:r0 + chunk]).to(dev, torch.float64)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)
        s, i = torch.topk(q @ v.T, min(k + 1, v.shape[0]), dim=1)
        i = i + r0
        if best_s is not None:
            s, at = torch.topk(torch.cat([best_s, s], 1), k + 1, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, at)
        best_s, best_i = s, i
    return best_s.cpu().numpy(), best_i.cpu().numpy()


def topk_numpy(vecs, queries, k):
    """The same oracle in numpy float64, for a few queries."""
    import numpy as np

    v = vecs.astype(np.float64)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    s = _unit_f32(queries).astype(np.float64) @ v.T
    i = np.argsort(-s, axis=1, kind="stable")[:, :k + 1]
    return np.take_along_axis(s, i, 1), i


def check_topk(what, got, exp_s, exp_i, k):
    """Every query has k results; their scores are within VEC_SCORE_TOL of
    the oracle's (float32 dot products of unit vectors at d = 100), and
    their ids are the oracle's but where its k-th and (k + 1)-th scores lie
    within VEC_TIE_TOL.  Returns (max score error, queries whose ids
    differ)."""
    import numpy as np

    nq = exp_s.shape[0]
    qi, sc, ids = got["query_idx"], got["score"], got["id"]
    if len(qi) != nq * k:
        fail(f"{what}: {len(qi)} rows, expected {nq} queries x {k}")
    order = np.lexsort((-sc, qi))
    qi, sc, ids = qi[order].reshape(nq, k), sc[order].reshape(nq, k), ids[order].reshape(nq, k)
    if not (qi == np.arange(nq)[:, None]).all():
        fail(f"{what}: queries without exactly {k} results")
    err = float(np.abs(sc - exp_s[:, :k]).max())
    if err > VEC_SCORE_TOL:
        fail(f"{what}: scores {err:.3g} from the oracle's (tolerance {VEC_SCORE_TOL})")
    differ = ~(np.sort(ids, 1) == np.sort(exp_i[:, :k], 1)).all(1)
    near = exp_s[:, k - 1] - exp_s[:, k] <= VEC_TIE_TOL
    if (differ & ~near).any():
        fail(f"{what}: ids differ from the oracle's on {int((differ & ~near).sum())} queries "
             "whose k-th and (k + 1)-th scores are apart")
    return err, int(differ.sum())


def prune_numpy(sidecar, queries, nprobe):
    """Row groups holding one of each query's nprobe closest cells, from the
    sidecar's arrays, in numpy float32 as the index computes them (the
    oracle of the pruning)."""
    import numpy as np

    idx = np.load(sidecar)
    cents, rg_cells = idx["centroids"], idx["rg_cells"]
    q = np.asarray(queries, dtype=np.float32)
    s = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)) @ (
        cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-9)).T
    probed = np.unique(np.argsort(-s, axis=1, kind="stable")[:, :nprobe])
    return np.flatnonzero(rg_cells[:, probed].any(axis=1))


def gram_oracle(li, covariance):
    """Gramian or covariance of LINALG_COLS in numpy float64 over the
    float32-cast columns."""
    import numpy as np

    x = np.stack([li.cols[c].astype(np.float32) for c in LINALG_COLS], 1).astype(np.float64)
    g = x.T @ x
    if covariance:
        mu = x.sum(0) / len(x)
        g = g / len(x) - np.outer(mu, mu)
    return g


def check_gram(what, got, exp):
    import numpy as np

    rows = {str(c): i for i, c in enumerate(got["column"])}
    if sorted(rows) != sorted(LINALG_COLS):
        fail(f"{what}: rows {sorted(rows)}")
    g = np.stack([got[c][[rows[r] for r in LINALG_COLS]] for c in LINALG_COLS], 1)
    if not np.allclose(g, exp, rtol=1e-9, atol=0):
        fail(f"{what}: beyond rtol 1e-9 of the float64 oracle "
             f"(max rel {np.max(np.abs(g - exp) / np.abs(exp)):.3g})")


def check_quantiles(got, exp):
    import numpy as np

    order = np.argsort(got["quantile"])
    if not np.allclose(got["quantile"][order], QUANTILES):
        fail(f"quantile: quantiles {got['quantile']}")
    est = got["l_extendedprice"][order]
    rel = np.abs(est - exp) / np.maximum(np.abs(exp), 0.1)
    if (rel >= 0.02).any():
        fail(f"quantile: t-digest {est} against np.quantile {exp} (relative {rel})")


def tpch_stream(name: str, ctx, tables):
    """TPC-H Q1, Q3, Q4, Q13, Q7, Q21 or Q5 over the made tables through the port's
    API (a reader per source: it holds the source's pushed-down
    projection).  The walls-only run uses it against another checkout's
    package too."""
    from quokka_tpu_torch import col, date

    def src(t):
        reader = TableReader(tables[t])
        return ctx.read_dataset(reader, schema=reader.schema)

    if name == "q1":
        return (src("lineitem").filter_sql(Q1_FILTER)
                .groupby(["l_returnflag", "l_linestatus"]).agg_sql(Q1_AGGS))
    if name == "q3":
        d = date(Q3_DATE)
        return (src("lineitem").filter(col("l_shipdate") > d)
                .join(src("orders").filter(col("o_orderdate") < d),
                      left_on="l_orderkey", right_on="o_orderkey")
                .join(src("customer").filter(col("c_mktsegment") == "BUILDING"),
                      left_on="o_custkey", right_on="c_custkey")
                .groupby(["l_orderkey", "o_orderdate", "o_shippriority"])
                .agg_sql(REV).top_k(["revenue"], 10, [True]))
    if name == "q4":
        return (src("orders")
                .filter_sql("o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01'")
                .join(src("lineitem").filter_sql("l_commitdate < l_receiptdate"),
                      left_on="o_orderkey", right_on="l_orderkey", how="semi")
                .groupby("o_orderpriority").agg_sql("count(*) as order_count"))
    if name == "q13":
        return (src("customer")
                .join(src("orders").filter(~col("o_comment").str.contains("special")),
                      left_on="c_custkey", right_on="o_custkey", how="left")
                .groupby("c_custkey").agg_sql("count(o_orderkey) as c_count")
                .groupby("c_count").agg_sql("count(*) as custdist"))
    if name == "q7":
        nation = src("nation")
        n1 = nation.rename({"n_name": "supp_nation", "n_nationkey": "n1key"})
        n2 = nation.rename({"n_name": "cust_nation", "n_nationkey": "n2key"})
        return (src("lineitem")
                .filter_sql("l_shipdate between date '1995-01-01' and date '1996-12-31'")
                .join(src("supplier"), left_on="l_suppkey", right_on="s_suppkey")
                .join(src("orders"), left_on="l_orderkey", right_on="o_orderkey")
                .join(src("customer"), left_on="o_custkey", right_on="c_custkey")
                .join(n1.select(["supp_nation", "n1key"]), left_on="s_nationkey",
                      right_on="n1key")
                .join(n2.select(["cust_nation", "n2key"]), left_on="c_nationkey",
                      right_on="n2key")
                .filter_sql(Q7_FILTER)
                .with_columns_sql("extract(year from l_shipdate) as l_year, "
                                  "l_extendedprice * (1 - l_discount) as volume")
                .groupby(["supp_nation", "cust_nation", "l_year"])
                .agg_sql("sum(volume) as revenue"))
    if name == "q21":
        late = src("lineitem").filter_sql("l_receiptdate > l_commitdate")
        n_supp = (src("lineitem").select(["l_orderkey", "l_suppkey"]).distinct()
                  .groupby("l_orderkey").agg_sql("count(*) as n_supp")
                  .rename({"l_orderkey": "ns_orderkey"}))
        n_late = (late.select(["l_orderkey", "l_suppkey"]).distinct()
                  .groupby("l_orderkey").agg_sql("count(*) as n_late")
                  .rename({"l_orderkey": "nl_orderkey"}))
        return (late.select(["l_orderkey", "l_suppkey"]).distinct()
                .join(src("orders").filter_sql("o_orderstatus = 'F'"),
                      left_on="l_orderkey", right_on="o_orderkey", how="semi")
                .join(n_supp, left_on="l_orderkey", right_on="ns_orderkey")
                .join(n_late, left_on="l_orderkey", right_on="nl_orderkey")
                .filter_sql("n_supp > 1 and n_late = 1")
                .join(src("supplier"), left_on="l_suppkey", right_on="s_suppkey")
                .join(src("nation").filter_sql(f"n_name = '{q21_nation(tables)}'"),
                      left_on="s_nationkey", right_on="n_nationkey", how="semi")
                .groupby("s_name").agg_sql("count(*) as numwait"))
    return (src("lineitem")
            .join(src("orders").filter_sql(
                "o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'"),
                left_on="l_orderkey", right_on="o_orderkey")
            .join(src("customer"), left_on="o_custkey", right_on="c_custkey")
            .join(src("supplier"), left_on=["l_suppkey", "c_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
            .join(src("nation"), left_on="c_nationkey", right_on="n_nationkey")
            .join(src("region").filter(col("r_name") == "ASIA"),
                  left_on="n_regionkey", right_on="r_regionkey")
            .groupby("n_name").agg_sql(REV))


def collect_numpy(stream, what: str):
    cols = stream.compute().to_numpy()
    if cols is None:
        fail(f"{what} returned no rows")
    return cols


def dryrun_q3_stream(ctx, tables):
    """dryrun_multichip's scan -> filter -> join -> join -> group-by
    (__graft_entry__.py:127-143) over the made TPC-H tables."""
    from quokka_tpu_torch import col

    def src(t):
        reader = TableReader(tables[t])
        return ctx.read_dataset(reader, schema=reader.schema)

    return (src("lineitem").filter(col("l_quantity") < 45)
            .join(src("orders"), left_on="l_orderkey", right_on="o_orderkey")
            .join(src("customer").filter(col("c_mktsegment") == "BUILDING"),
                  left_on="o_custkey", right_on="c_custkey")
            .groupby("l_orderkey")
            .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue, count(*) as n"))


def dryrun_q3_oracle(t):
    """Per l_orderkey of the shape: revenue and line count."""
    import numpy as np

    li, o, c = t["lineitem"].cols, t["orders"].cols, t["customer"].cols
    oi, hit = _pk_lookup(o["o_orderkey"], li["l_orderkey"])
    sel = (li["l_quantity"] < 45) & hit
    cm = c["c_mktsegment"] == SEGMENTS.index("BUILDING")
    _, chit = _pk_lookup(c["c_custkey"][cm], o["o_custkey"][oi[sel]])
    rows = np.nonzero(sel)[0][chit]
    rev = li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])
    keys, inv = np.unique(li["l_orderkey"][rows], return_inverse=True)
    return {"keys": keys, "revenue": np.bincount(inv, rev, len(keys)),
            "n": np.bincount(inv, minlength=len(keys))}


def check_dryrun_q3(got, exp) -> None:
    import numpy as np

    order = np.argsort(got["l_orderkey"], kind="stable")
    if not np.array_equal(got["l_orderkey"][order], exp["keys"]):
        fail(f"dryrun q3 shape: {len(order)} groups differ from the oracle's {len(exp['keys'])}")
    if not np.array_equal(got["n"][order], exp["n"]):
        fail("dryrun q3 shape: line counts differ from the oracle (exact)")
    if not np.allclose(got["revenue"][order], exp["revenue"], rtol=1e-9, atol=0):
        fail("dryrun q3 shape: revenue beyond rtol 1e-9 of the oracle")


# ---------------------------------------------------------------------------
# timing and capture
# ---------------------------------------------------------------------------


# the device operations of one K3 call and of one K20b call, by the start
# of the profiler's names (a memset is "Memset (Device)")
K3_OPS = ("Memset", "qk_gb_insert_kernel", "qk_gb_rank_kernel", "qk_gb_segment_kernel")
K19_OPS = ("Memset", "qk_fill_chain_kernel")
K19B_OPS = ("Memset", "qk_bounds_chain_kernel")
K20A_OPS = ("Memset", "qk_window_check_kernel", "qk_window_bounds_kernel")
K20B_OPS = ("qk_range_summary_kernel", "qk_range_query_kernel")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """{kernel name: (device us, count)} of a profile, device-side events only.
    A template kernel's demangled name starts with its return type ("void
    qk_minmax_level_kernel<double>(...)"): that prefix is dropped, so every
    kernel is found by the start of its own name."""
    import torch

    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t:
            key = ev.key[5:] if ev.key.startswith("void qk_") else ev.key
            out[key] = (float(t), int(ev.count))
    return out


def kernel_us(fn, prefixes=None, iters: int = 10, expect=()):
    """({kernel: device us per call of fn}, the profile) over a window of
    ``iters`` calls (device-side events only; only the kernels whose names
    start with ``prefixes`` when given).  The profiler drops kernel records
    in a long process, so a kernel's time is its mean over the launches
    recorded, times its launches per call: the recorded launches over the
    calls, rounded up.  A window in which some kernel's launches are not a
    whole multiple of the calls, or that recorded none, is taken again, up
    to three times, and the one that recorded the most launches is kept
    (``per_call_us``).  ``expect`` names (by the start of their names) the
    device operations every call makes: a window that recorded none of one
    of them is taken again, up to eight times in all, and the run fails if
    no window recorded them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(8 if expect else 3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = {k: tc for k, tc in device_events(prof).items()
              if prefixes is None or k.startswith(prefixes)}
        whole = all(any(k.startswith(e) for k in ev) for e in expect)
        rank = (whole, sum(c for _, c in ev.values()))
        if best is None or rank > best[0]:
            best = (rank, ev, prof)
        if whole and ev and all(c % iters == 0 for _, c in ev.values()):
            break
    if not best[0][0]:
        missing = [e for e in expect if not any(k.startswith(e) for k in best[1])]
        fail(f"device time: no profiled window recorded {missing} (recorded: "
             f"{sorted(k.split('(')[0] for k in best[1])})")
    return per_call_us(best[1], iters), best[2]


def per_call_us(ev, iters: int) -> dict:
    """{kernel: device us per call} of a window's {kernel: (us, recorded
    launches)} over ``iters`` calls: each kernel's mean per recorded launch
    times its launches per call, the recorded ones over the calls rounded
    up (right while the profiler drops fewer than ``iters`` of them)."""
    return {k: t / c * -(-c // iters) for k, (t, c) in ev.items()}


def device_us(fn, prefixes=None, iters: int = 10, expect=()) -> float:
    """Device time per call of fn: the sum of ``kernel_us``."""
    return sum(kernel_us(fn, prefixes, iters, expect)[0].values())


def profile_counts(prof):
    """(device busy seconds, device-to-host copies, cudaStreamSynchronize
    calls) of a profile."""
    import torch

    busy, d2h, syncs = 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            busy += float(t if t is not None else getattr(ev, "self_cuda_time_total", 0))
            if ev.key.startswith("Memcpy DtoH"):
                d2h += int(ev.count)
        elif ev.key == "cudaStreamSynchronize":
            syncs += int(ev.count)
    return busy / 1e6, d2h, syncs


COMPARED = ("q1", "q3", "q5")
WALL_TPCH = COMPARED + ("q13", "q7", "q21")
WALL_TICKS = ("tumbling", "hopping", "session", "sliding", "shift")


def query_walls(dev, streams) -> dict:
    """Each of ``streams`` ({path: stream of a context}) through the package
    on sys.path: the cold wall, three warm walls, the read + bridge seconds
    of a timed warm run, and one profiled run's device busy time, idle share of the warm median, D2H
    copies and cudaStreamSynchronize calls, with the count reads the
    operator-statistics ledger made in it (0 where the package has none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.runtime import engine as engine_mod

    try:
        from quokka_tpu_torch import obs
    except ImportError:  # a checkout from before the ledger
        obs = None

    def ledger_reads() -> int:
        return 0 if obs is None else obs.REGISTRY.counter("opstats.count_reads").value

    ctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    Engine = engine_mod.Engine
    real = Engine._read_and_bridge
    out = {}
    for q, stream in streams.items():
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collect_numpy(stream(ctx), q)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        cold = run()
        warm = [run() for _ in range(3)]
        spent = [0.0]

        def read_and_bridge(self, *a):
            t = time.perf_counter()
            try:
                return real(self, *a)
            finally:
                spent[0] += time.perf_counter() - t

        Engine._read_and_bridge = read_and_bridge
        try:
            timed = run()
        finally:
            Engine._read_and_bridge = real
        reads0 = ledger_reads()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        busy, d2h, syncs = profile_counts(prof)
        med = sorted(warm)[1]
        out[q] = {"cold_s": cold, "warm_s": warm, "timed_wall_s": timed,
                  "read_bridge_s": spent[0], "device_busy_s": busy,
                  "idle_share_of_warm": 1 - busy / med, "d2h": d2h, "syncs": syncs,
                  "ledger_count_reads": ledger_reads() - reads0}
    return out


def vector_streams(dev, pkg: Path, args) -> dict:
    """The vector and ann paths' streams, as the smoke drives them, over the
    data it makes from the seed (the ANN file and its index under pkg's
    build/)."""
    import numpy as np
    import pyarrow.parquet as pq
    from quokka_tpu_torch.dataset import vector as dvec
    from quokka_tpu_torch.dataset.readers import InputArrowDataset

    vd = make_vectors(args.sf, args.seed)
    corpus = vector_table(vd["vecs"], vd["null"])
    ann_dir = pkg / "build" / "chip_smoke"
    ann_dir.mkdir(parents=True, exist_ok=True)
    ann_path = str(ann_dir / "ann.parquet")
    pq.write_table(vector_table(vd["ann"], np.zeros(len(vd["ann"]), dtype=bool)), ann_path,
                   row_group_size=len(vd["ann"]) // ANN_ROW_GROUPS)
    dvec.build_vector_index(ann_path, "emb", n_cells=ANN_CELLS, device=dev)
    ann_q = vd["queries"][:ANN_QUERIES]
    return {
        "vector": lambda ctx: ctx.read_dataset(
            InputArrowDataset(corpus, batch_rows=BATCH_ROWS)).nearest_neighbors(
            vd["queries"], "emb", VEC_K),
        "ann": lambda ctx: ctx.read_parquet(ann_path).nearest_neighbors(
            ann_q, "emb", VEC_K, approximate=True, nprobe=ANN_NPROBE)}


def walls_only(args) -> int:
    """``--walls-only``: the walls and copy / sync counts of the paths in
    ``--walls-paths`` (Q1, Q3 and Q5 by default; also Q13, Q7, the
    tumbling, hopping, session and sliding windows, shift, and the vector and ann
    paths, over the data the smoke makes for them) through the package in
    ``--package`` (a checkout's root), as one JSON line."""
    import torch

    pkg = Path(args.package).resolve()
    if not (pkg / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no quokka_tpu_torch package in {pkg}", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = str(pkg / "build" / "quokka_tpu_torch" / "triton")
    sys.path.insert(0, str(pkg))
    from quokka_tpu_torch.ops import native

    native.build_all()
    dev = torch.device("cuda", 0)
    paths = args.walls_paths.split(",")
    unknown = sorted(set(paths) - set(WALL_TPCH) - set(WALL_TICKS) - {"vector", "ann"})
    if unknown:
        print(f"chip_smoke: --walls-paths: no path {unknown}", file=sys.stderr)
        return 2
    streams = {}
    if set(paths) & set(WALL_TPCH):
        tables = make_tpch(args.sf, args.seed)
        streams.update({q: (lambda ctx, q=q: tpch_stream(q, ctx, tables))
                        for q in paths if q in WALL_TPCH})
    if set(paths) & set(WALL_TICKS):
        ticks = make_ticks(args.sf, args.seed)
        streams.update({q: (lambda ctx, q=q: tick_stream(q, ctx, ticks))
                        for q in paths if q in WALL_TICKS})
    if {"vector", "ann"} & set(paths):
        streams.update(vector_streams(dev, pkg, args))
    walls = query_walls(dev, {p: streams[p] for p in paths})
    print(json.dumps({"walls": walls, "package": str(pkg)}))
    return 0


def k23_cases(seed: int):
    """Wire layouts beyond the query batches': (label, [leaf lists under
    one signature]).  NaN / -0.0 dictionaries, uint16 codes, a plan that
    widens then degrades, an all-pass layout and a 0-row batch."""
    import numpy as np
    from quokka_tpu_torch.ops import pack

    r = np.random.default_rng(seed)
    n = 1 << 20
    specials = np.array([0.0, -0.0, np.nan, 0.01, 0.02, 0.05, 0.07, 0.1])
    wide = np.round(r.uniform(0, 1000, 300), 3)
    return [
        ("NaN and -0.0 dictionaries", [[pack.ValidCount(n, n - 5), r.choice(specials, n),
                                        r.choice(specials, n).astype(np.float32)]]),
        ("uint16 codes", [[pack.ValidCount(n, n), r.choice(wide[:150], n)],
                          [pack.ValidCount(n, n), r.choice(wide, n)]]),
        ("widen then degrade", [
            [pack.ValidCount(n, n), r.integers(0, 200, n), r.choice(specials, n)],
            [pack.ValidCount(n, n), r.integers(-5000, 5000, n), r.choice(wide[:180], n)],
            [pack.ValidCount(n, n), r.integers(-2**40, 2**40, n), r.normal(size=n)],
            [pack.ValidCount(n, n), r.integers(0, 200, n), r.choice(specials, n)]]),
        ("all pass", [[pack.ValidCount(n, n), r.integers(-2**40, 2**40, n),
                       r.normal(size=n), r.normal(size=(4096, 8))]]),
        ("0-row batch", [[pack.ValidCount(256, 0), np.zeros(256, dtype=np.int64),
                          np.zeros(256), np.zeros(256, dtype=bool)]]),
    ]


def check_k23(dev, label: str, leaves) -> dict:
    """K23 against its plain version and the shipped input, bit for bit, on
    one batch; returns the staged batch and its byte counts."""
    import numpy as np
    import torch
    from quokka_tpu_torch.ops import pack

    wires, layout = pack._encode(leaves)
    st = pack.stage(layout, wires, dev)
    got = [t.clone() for t in pack.decode_launch(st)]
    exp = pack.decode_plain(layout, st.wires)
    torch.cuda.synchronize()

    def bits(t):
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32) \
            if t.is_floating_point() else t

    for i, (leaf, g, e) in enumerate(zip(leaves, got, exp)):
        want = (torch.arange(leaf.padded) < leaf.nrows if isinstance(leaf, pack.ValidCount)
                else torch.from_numpy(np.ascontiguousarray(leaf)))
        if not (g.dtype == e.dtype and g.shape == e.shape and torch.equal(bits(g), bits(e))
                and torch.equal(bits(g.cpu()), bits(want))):
            fail(f"K23 {label}: leaf {i} ({layout[i]}) differs from the plain version "
                 "or the input")
    read, write = pack._cost(layout, wires)
    return {"st": st, "layout": layout, "wires": wires, "read": read, "write": write,
            "kinds": [spec[0] for spec in layout]}


# K8's cases beyond Q3's concat: each a list of parts, (rows, live share)
K8_CASES = {
    "lengths not multiples of 4096": [(5000, 0.7), (256, 0.5), (12_289, 0.9), (70_001, 0.3)],
    "one part of 2^24 rows": [(1 << 24, 0.6), (4096, 0.5)],
    "more columns than the cap": [(30_000, 0.6), (70_000, 0.4)],
    "mixed dtypes across parts": [(30_000, 0.6), (70_000, 0.4), (5, 1.0)],
    "strided sources": [(30_000, 0.6), (70_000, 0.4)],
    "empty and all-invalid parts": [(0, 0.5), (3000, 0.0), (90_000, 0.6), (4096, 0.0)],
}


def k8_parts(dev, label: str, seed: int):
    """K8_CASES[label] as batches on dev: int64, float64 with NaN, bool, and
    (but for the 2^24-row part) int32, date, timestamp (ms), float32, a
    string column with its own dictionary order and null codes, and 3- and
    2-wide vectors; int16 columns past the cap; int32 / float64 in the
    first part where the others hold int64 / float32; strided sources."""
    import numpy as np
    import torch
    from quokka_tpu_torch.ops import bridge
    from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol, StringDict, VecCol

    r = np.random.default_rng(seed)
    out = []
    for i, (m, dens) in enumerate(K8_CASES[label]):
        f = r.normal(size=m)
        f[r.random(m) < 0.1] = np.nan
        cols = {"i": NumCol(torch.from_numpy(r.integers(-10**12, 10**12, m)), "i"),
                "f": NumCol(torch.from_numpy(f), "f"),
                "b": NumCol(torch.from_numpy(r.random(m) < 0.5), "b")}
        if m < 1 << 24:
            cols.update(
                n=NumCol(torch.from_numpy(r.integers(-100, 100, m).astype(np.int32)), "i"),
                d=NumCol(torch.from_numpy(r.integers(0, 20_000, m).astype(np.int32)), "d"),
                t=NumCol(torch.from_numpy(r.integers(0, 10**13, m)), "t", "ms"),
                h=NumCol(torch.from_numpy(r.normal(size=m).astype(np.float32)), "f"),
                s=StrCol(torch.from_numpy(r.integers(-1, 3, m).astype(np.int32)),
                         StringDict(np.array(["x", "y", "z"], dtype=object)[r.permutation(3)])),
                v=VecCol(torch.from_numpy(r.normal(size=(m, 3)))),
                w=VecCol(torch.from_numpy(r.normal(size=(m, 2)))))
        if label == "more columns than the cap":
            for j in range(bridge.CONCAT_MAX_COLUMNS + 3):
                cols[f"x{j}"] = NumCol(torch.from_numpy(r.integers(0, 999, m).astype(np.int16)),
                                       "i")
        if label == "mixed dtypes across parts" and i == 0:
            cols["i"] = NumCol(cols["i"].data.to(torch.int32), "i")
            cols["h"] = NumCol(cols["h"].data.double(), "f")
        cols = {k: (StrCol(c.codes.to(dev), c.dictionary) if isinstance(c, StrCol)
                    else VecCol(c.data.to(dev)) if isinstance(c, VecCol)
                    else NumCol(c.data.to(dev), c.kind, c.unit)) for k, c in cols.items()}
        valid = torch.from_numpy(r.random(m) < dens).to(dev)
        if label == "strided sources":
            cols["i"] = NumCol(torch.stack([cols["i"].data] * 2, 1)[:, 1], "i")
            valid = torch.stack([valid] * 2, 1)[:, 0]
        out.append(DeviceBatch(cols, valid, int(valid.sum())))
    return out


def same_batch(a, b) -> bool:
    """Bit for bit: live count, validity, column order, kinds, units,
    dictionaries, dtypes and every padded row (floats as their bits)."""
    import torch

    def bits(t):
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()]) \
            if t.is_floating_point() else t

    if a.nrows != b.nrows or not torch.equal(a.valid, b.valid) \
            or list(a.columns) != list(b.columns):
        return False
    for name, x in a.columns.items():
        y = b.columns[name]
        tx, ty = (x.codes, y.codes) if hasattr(x, "codes") else (x.data, y.data)
        if type(x) is not type(y) or tx.dtype != ty.dtype or tx.shape != ty.shape \
                or getattr(x, "kind", None) != getattr(y, "kind", None) \
                or getattr(x, "unit", None) != getattr(y, "unit", None) \
                or not torch.equal(bits(tx), bits(ty)):
            return False
        if hasattr(x, "dictionary") and list(x.dictionary.values) != list(y.dictionary.values):
            return False
    return True


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


class Capture:
    """Count the calls of module functions during one run and keep the
    arguments of the largest call of each (``size(args)`` decides)."""

    def __init__(self, targets, keep_every=()):
        self.targets = targets  # name -> (module, attr, size)
        self.calls = {n: 0 for n in targets}
        self.args = {}
        self.every = {n: [] for n in keep_every}  # every call's arguments
        self._best = {}
        self._saved = []

    def __enter__(self):
        for name, (mod, attr, size) in self.targets.items():
            real = getattr(mod, attr)
            self._saved.append((mod, attr, real))

            def wrap(*a, _name=name, _real=real, _size=size, **kw):
                self.calls[_name] += 1
                if _name in self.every:
                    self.every[_name].append((a, kw))
                s = _size(*a, **kw)
                if s >= self._best.get(_name, -1):
                    self._best[_name] = s
                    self.args[_name] = (a, kw)
                return _real(*a, **kw)

            setattr(mod, attr, wrap)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        return False


class Row20Spy:
    """Counts the calls of row 20's flip and cummin (``_rows_from_segment_end``,
    the plain version of K19's segment ends) made on CUDA tensors,
    under both names the package gives it (``ops/asof.py`` and the
    executors' module); ``calls`` is set to 0 before a path's run."""

    def __init__(self):
        self.calls = 0
        self._saved = []

    def __enter__(self):
        from quokka_tpu_torch.executors import ts_execs
        from quokka_tpu_torch.ops import asof

        for mod in (asof, ts_execs):
            real = mod._rows_from_segment_end
            self._saved.append((mod, real))

            def spy(iota, flag, n, _real=real):
                self.calls += iota.is_cuda
                return _real(iota, flag, n)

            mod._rows_from_segment_end = spy
        return self

    def __exit__(self, *exc):
        for mod, real in reversed(self._saved):
            mod._rows_from_segment_end = real
        return False


class ConcatSpy:
    """Counts the compacting concats of CUDA batches (``bridge.compact_concat``
    calls), the K8 launches they take (one a ``CONCAT_MAX_COLUMNS`` columns)
    and the ``torch.nonzero`` calls made inside them, which must be none."""

    def __init__(self):
        self.calls = self.launches = self.nonzero = 0
        self._saved = None

    def __enter__(self):
        import torch
        from quokka_tpu_torch.ops import bridge

        real, real_nz = bridge.compact_concat, torch.nonzero
        self._saved = (bridge, real, torch, real_nz)
        inside = [0]

        def nonzero(*a, **kw):
            self.nonzero += bool(inside[0]) and bool(a) and getattr(a[0], "is_cuda", False)
            return real_nz(*a, **kw)

        def spy(batches, per_col, dicts, total, padded):
            if batches[0].valid.is_cuda:
                self.calls += 1
                self.launches += max(1, -(-len(per_col) // bridge.CONCAT_MAX_COLUMNS))
            inside[0] += 1
            try:
                return real(batches, per_col, dicts, total, padded)
            finally:
                inside[0] -= 1

        bridge.compact_concat, torch.nonzero = spy, nonzero
        return self

    def __exit__(self, *exc):
        bridge, real, torch, real_nz = self._saved
        bridge.compact_concat, torch.nonzero = real, real_nz
        return False

    def check(self, path: str, launched: int) -> None:
        """The gate: K8's launches on the path are the compacting concats'
        (one a CONCAT_MAX_COLUMNS columns), and none of them ran a nonzero."""
        if launched != self.launches or self.nonzero:
            fail(f"{path}: {launched} K8 launches for {self.calls} compacting concats "
                 f"(expected {self.launches} launches), {self.nonzero} torch.nonzero calls "
                 "inside them")


class PlanSortSpy:
    """Counts the dense ranks (``kernels.dense_rank``: K10) and many-to-many
    plans (``join._mm_plan_dispatch``: K13p) of CUDA batches, the radix
    sorts they launch (``kernels.SORT_LAUNCHES``), and the
    ``kernels.lexsort_perm`` and ``torch.sort`` calls made inside them:
    one radix sort a call and neither of the others."""

    def __init__(self):
        self.ranks = self.plans = self.sorts = self.lexsorts = self.torch_sorts = 0
        self._saved = None

    def __enter__(self):
        import torch
        from quokka_tpu_torch.ops import join, kernels

        real_rank, real_plan = kernels.dense_rank, join._mm_plan_dispatch
        real_lex, real_sort = kernels.lexsort_perm, torch.sort
        self._saved = (join, kernels, torch, real_rank, real_plan, real_lex, real_sort)
        inside = [0]

        def lex(keys):
            self.lexsorts += bool(inside[0])
            return real_lex(keys)

        def tsort(*a, **k):
            self.torch_sorts += bool(inside[0])
            return real_sort(*a, **k)

        def watched(real, counter):
            def call(*a):
                cuda = a[1].is_cuda
                if not cuda or inside[0]:
                    return real(*a)
                setattr(self, counter, getattr(self, counter) + 1)
                before = kernels.SORT_LAUNCHES
                inside[0] += 1
                try:
                    return real(*a)
                finally:
                    inside[0] -= 1
                    self.sorts += kernels.SORT_LAUNCHES - before
            return call

        kernels.dense_rank = watched(real_rank, "ranks")
        join._mm_plan_dispatch = watched(real_plan, "plans")
        kernels.lexsort_perm, torch.sort = lex, tsort
        return self

    def __exit__(self, *exc):
        join, kernels, torch, real_rank, real_plan, real_lex, real_sort = self._saved
        kernels.dense_rank, join._mm_plan_dispatch = real_rank, real_plan
        kernels.lexsort_perm, torch.sort = real_lex, real_sort
        return False

    def check(self, path: str, k10: int, k13p: int) -> None:
        """The gate: one K13p launch a plan, one K10 launch a dense rank
        and a plan, one radix sort a call, no lexsort_perm or torch.sort
        inside them."""
        if (k13p != self.plans or k10 != self.ranks + self.plans
                or self.sorts != self.ranks + self.plans or self.lexsorts or self.torch_sorts):
            fail(f"{path}: {k10} K10 and {k13p} K13p launches and {self.sorts} radix sorts "
                 f"for {self.ranks} dense ranks and {self.plans} many-to-many plans, with "
                 f"{self.lexsorts} lexsort_perm and {self.torch_sorts} torch.sort calls inside "
                 "them (expected one radix sort a call and none of the others)")


# the device operations of every K17 call: a memset and two kernels
K17_OPS = ("Memset", "qk_plan_count_kernel", "qk_plan_place_kernel")

# K19's segment bounds per query on sliding and shift: one a batch the
# executor processes (bench.py's ticks: 12)
SEGMENT_BOUNDS_PER_QUERY = 12


# ---------------------------------------------------------------------------
# the mesh plane: QuokkaContext(mesh=make_mesh(8)), eight shards on one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
K24_CASE_ROWS = 1 << 21  # input rows of K24's checks beyond Q3's (64 shards: 2^16)
# what no mesh path may launch: the mesh hashes itself (no K4 / K17 / K26),
# groups by the sort group-by (no K2 / K5 / K6), joins by rank (no K11 /
# K12; K13 only for a many-to-many join, which no path here has) and takes
# the sort as-of (no K18)
MESH_MUST_NOT = ["K2", "K2 pre", "K4", "K5", "K6", "K11 build", "K11", "K12", "K13", "K17",
                 "K18", "K21", "K22", "K26"]


def mesh_paths(tables, ticks):
    """path -> (stream over a context, check, oracle key, kernels it must
    launch besides K23 and K24)."""
    def tp(q):
        return lambda c: tpch_stream(q, c, tables)

    def tk(q):
        return lambda c: tick_stream(q, c, ticks)

    return {
        "mesh q1": (tp("q1"), check_q1, "q1", ["K1", "K16"]),
        "mesh q3": (tp("q3"), check_q3, "q3", ["K1", "K16", "K14"]),
        "mesh q5": (tp("q5"), check_q5, "q5", ["K1", "K16", "K14"]),
        "mesh dryrun q3 shape": (lambda c: dryrun_q3_stream(c, tables), check_dryrun_q3,
                                 "dryrun q3 shape", ["K1", "K16", "K14"]),
        "mesh dryrun asof shape": (tk("asof shape"), check_asof, "dryrun asof shape", ["K19"]),
        "mesh asof": (tk("asof"), check_asof, "asof", ["K16", "K19"]),
        "mesh asof forward": (tk("asof forward"), check_asof, "asof forward", ["K16", "K19"]),
        "mesh tumbling": (tk("tumbling"), check_tumbling, "tumbling", ["K16"]),
        "mesh hopping": (tk("hopping"), check_hopping, "hopping", []),
        "mesh session": (tk("session"), check_session, "session", []),
        "mesh sliding": (tk("sliding"), check_sliding, "sliding",
                         ["K16", "K19 bounds", "K20a", "K20b"]),
        "mesh shift": (tk("shift"), check_shift, "shift", ["K19 bounds"]),
    }


def mesh_phase(dev, tables, ticks, oracles, engine_walls, counters):
    """Phase 4b: every mesh path through QuokkaContext(mesh=make_mesh(8)) on
    the card, each against its numpy oracle, with each kernel's launch
    count set to 0 just before the cold run and read just after.  Fails
    on a fallback to the engine, a per-step batch, a kernel of the path not
    launched (K24 on every path, K14 on every path with a PK join) or one
    the mesh does not run, devprof dispatches that differ from launches, or
    K23 launches that differ from the landed batches (sources and
    ``_materialize``'s round trips).  Times the cold and warm walls beside
    the engine's for the same query, the peak device memory of the cold
    run, and one profiled warm run's device busy time, idle share, D2H
    copies and cudaStreamSynchronize calls.  Returns (report, launches per
    path, the arguments of Q3's largest K24 and K14 calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.obs import devprof
    from quokka_tpu_torch.ops import fuse, join, kernels, pack, stagefuse
    from quokka_tpu_torch.parallel import make_mesh

    torch.empty(1, device=dev)  # the allocator's peak counters exist once it has run
    mesh = make_mesh(MESH_SHARDS, device=dev)
    mctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev, mesh=mesh)
    ectx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    real_put = pack.pack_put
    landed = [0]

    def counted_put(leaves, device):
        landed[0] += torch.device(device).type == dev.type
        return real_put(leaves, device)

    def charged():
        by = {}
        for row in devprof.costs_snapshot():
            if row["device"] == dev.type:
                by[row["kernel"]] = by.get(row["kernel"], 0) + row["dispatches"]
        return by

    def run(build, ctx, what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = collect_numpy(build(ctx), what)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    per_row = {"mesh sliding", "mesh shift"}
    report, launches_by = {}, {}
    for path, (build, check, okey, must) in mesh_paths(tables, ticks).items():
        exp = oracles[okey]
        for mod, attr in list(counters.values()) + [(fuse, "FALLBACKS"),
                                                     (stagefuse, "SEQUENTIAL")]:
            setattr(mod, attr, 0)
        landed[0] = 0
        charged0 = charged()
        torch.cuda.reset_peak_memory_stats(dev)
        pack.pack_put = counted_put
        try:
            with Row20Spy() as row20, ConcatSpy() as concat, PlanSortSpy() as plans:
                got, cold = run(build, mctx, path)
        finally:
            pack.pack_put = real_put
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        charged1 = charged()
        miscounted = {k: (n, charged1.get(k, 0) - charged0.get(k, 0))
                      for k, n in launches.items() if charged1.get(k, 0) - charged0.get(k, 0) != n}
        if mctx.last_mesh_fallback is not None:
            fail(f"{path}: fell back to the engine: {mctx.last_mesh_fallback}")
        if fuse.FALLBACKS or stagefuse.SEQUENTIAL:
            fail(f"{path}: {fuse.FALLBACKS} unfused fallbacks, {stagefuse.SEQUENTIAL} per-step "
                 "stage batches")
        if miscounted:
            fail(f"{path}: launches vs devprof dispatches differ: {miscounted}")
        if launches["K23"] != landed[0]:
            fail(f"{path}: {launches['K23']} K23 launches for {landed[0]} landed batches")
        concat.check(path, launches["K8"])
        plans.check(path, launches["K10"], launches["K13p"])
        missing = [k for k in ["K23", "K24", "K8"] + must if launches[k] == 0]
        if missing:
            fail(f"kernels not launched on the {path} run: {missing}")
        stray = [k for k in MESH_MUST_NOT if launches[k] != 0]
        if stray:
            fail(f"kernels launched on the {path} run that the mesh does not run: {stray}")
        # each shard's windows take their segment bounds from K19, not row 20
        if path == "mesh sliding" and (row20.calls
                                       or launches["K19 bounds"] != launches["K20a"]):
            fail(f"{path}: {row20.calls} flip + cummin calls on the card and "
                 f"{launches['K19 bounds']} K19 segment bounds for {launches['K20a']} K20a")
        check(got, exp)
        rows_out = len(next(iter(got.values())))
        warm = []
        for _ in range(2):
            again, wall = run(build, mctx, path)
            warm.append(wall)
            if path not in per_row:
                check(again, exp)
            elif len(next(iter(again.values()))) != rows_out:
                fail(f"{path}: a warm run returned another number of rows")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(build, mctx, path)
        busy, d2h, syncs = profile_counts(prof)
        top = sorted(device_events(prof).items(), key=lambda kv: -kv[1][0])[:8]
        med = sorted(warm)[len(warm) // 2]
        eng = engine_walls.get(okey)
        if eng is None:
            # a shape no engine path ran: the engine's walls now, on its oracle
            got_e, cold_e = run(build, ectx, okey)
            check(got_e, exp)
            eng = {"cold_s": cold_e, "warm_s": [run(build, ectx, okey)[1] for _ in range(2)]}
        launches_by[path] = launches
        report[path] = {"cold_s": cold, "warm_s": warm, "engine_cold_s": eng["cold_s"],
                        "engine_warm_s": eng["warm_s"], "peak_bytes": peak,
                        "device_busy_s": busy, "warm_median_s": med,
                        "idle_share_of_warm": None if busy == 0 else 1 - busy / med,
                        "d2h": d2h, "syncs": syncs, "landed_batches": landed[0],
                        "rows_out": rows_out, "launches": launches, "top": top}
        print(f"{path} sf: cold {cold:.3f} s, warm {[round(w, 4) for w in warm]} s; engine "
              f"cold {eng['cold_s']:.3f} s, warm {[round(w, 4) for w in eng['warm_s']]} s; "
              f"peak {peak / 2**30:.2f} GiB; device busy {busy:.4f} s, idle share "
              f"{'not measured' if busy == 0 else round(1 - busy / med, 4)}; {d2h} D2H copies, "
              f"{syncs} cudaStreamSynchronize; {landed[0]} landed batches; launches "
              f"{ {k: v for k, v in launches.items() if v} }; matches the numpy oracle")
        print(f"{path} device time by kernel (us, calls): "
              + "; ".join(f"{k[:60]} {t:.0f} ({c})" for k, (t, c) in top[:4]))
    # Q3's largest K24 and K14 calls, and Q5's largest K14 call, for phase 6
    with Capture({"K24": (kernels, "mesh_bucketize",
                          lambda cols, valid, key_idx, n: valid.shape[0] * len(cols)),
                  "K14": (join, "pk_match_ranks", lambda r, v, p: v.shape[0])}) as cap:
        run(mesh_paths(tables, ticks)["mesh q3"][0], mctx, "mesh q3")
    print(f"mesh q3 calls per query: {cap.calls}")
    with Capture({"K14": (join, "pk_match_ranks", lambda r, v, p: v.shape[0])}) as cap5:
        run(mesh_paths(tables, ticks)["mesh q5"][0], mctx, "mesh q5")
    print(f"mesh q5 calls per query: {cap5.calls}")
    cap.args["K14 q5"] = cap5.args["K14"]
    return report, launches_by, cap


def _k24_cases(dev, seed: int):
    """K24 inputs beyond Q3's: (label, cols, valid, key_idx, n_parts) at 1,
    2, 8 and 64 shards, with every leaf width (bool, uint8, int32, float32,
    int64, float64), all rows invalid, one bucket holding every row, and
    float key limbs holding NaN and -0.0."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed + 24)

    def make(n_parts, n, case="mixed"):
        total = n_parts * n
        k0 = r.integers(-5, 1 << 20, total).astype(np.int32)
        k1 = r.integers(-2**40, 2**40, total)
        f = r.normal(size=total)
        if case == "one bucket":
            k0[:], k1[:] = 3, 11
        if case == "float limbs":
            f = r.choice(np.array([0.0, -0.0, np.nan, 2.5, -3.7, 1e12, -1e12]), total)
        valid = np.zeros(total, bool) if case == "all invalid" else r.random(total) < 0.8
        cols = [k0, k1, f, f.astype(np.float32), r.random(total) < 0.5,
                r.integers(0, 255, total).astype(np.uint8), r.integers(0, 9, total).astype(np.int32)]
        key_idx = (0, 2) if case == "float limbs" else (0, 1)
        return ([torch.from_numpy(c).to(dev) for c in cols], torch.from_numpy(valid).to(dev),
                key_idx, n_parts)

    out = [(f"{p} shards", *make(p, K24_CASE_ROWS // p)) for p in (1, 2, 8)]
    out.append(("64 shards", *make(64, 1 << 10)))
    out += [(f"8 shards, {c}", *make(8, K24_CASE_ROWS // 8, c))
            for c in ("all invalid", "one bucket", "float limbs")]
    return out


def mesh_kernel_rows(dev, cap, launches_by, seed: int):
    """K24 and K14 against their plain versions on the card, bit for bit:
    K24 at Q3's largest shuffle and the ``_k24_cases``; K14 at Q3's and Q5's
    largest calls and, at Q3's shape, with duplicate build keys, no matches
    and every row invalid.  Each timed with CUDA events beside its bound, its plain
    version and (K24) one stable torch.sort of its part ids."""
    import numpy as np
    import torch

    from quokka_tpu_torch.ops import join, kernels

    def bits(t):
        if t.dtype == torch.bool:
            return t.view(torch.uint8)
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32) \
            if t.is_floating_point() else t

    def check_k24(label, cols, valid, key_idx, n_parts):
        got, gv = kernels.mesh_bucketize(cols, valid, key_idx, n_parts)
        exp, ev = kernels.mesh_bucketize_plain(cols, valid, key_idx, n_parts)
        torch.cuda.synchronize()
        if not (torch.equal(gv, ev) and all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
                                             for a, b in zip(got, exp))):
            fail(f"K24 {label}: exchanged columns or validity differ from the plain version")
        print(f"K24 {label}: {valid.shape[0]} rows, {len(cols)} leaves, {n_parts} shards: "
              "matches the plain version bit for bit")

    (k24_cols, k24_valid, k24_keys, k24_p), _ = cap.args["K24"]
    check_k24("Q3's largest shuffle", k24_cols, k24_valid, k24_keys, k24_p)
    for case in _k24_cases(dev, seed):
        check_k24(*case)
    pids = kernels._hash_pids_plain([k24_cols[i] for i in k24_keys], k24_p)
    widths = sum(c.element_size() for c in k24_cols) + 1
    n24 = k24_valid.shape[0]
    k24 = dict(
        name="K24 mesh bucketize + exchange", route="cuda",
        source="quokka_tpu_torch/csrc/partition.cu", replaces="quokka_tpu/parallel/mesh.py:72",
        launches=launches_by["mesh q3"]["K24"], max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.mesh_bucketize(k24_cols, k24_valid, k24_keys, k24_p), iters=10),
        plain_ms=cuda_ms(lambda: kernels.mesh_bucketize_plain(k24_cols, k24_valid, k24_keys,
                                                              k24_p), iters=3, warmup=1),
        bound_ms=bound_ms(nbytes(*k24_cols, k24_valid) + k24_p * n24 * widths),
        bound_by="bytes", library_ms=cuda_ms(lambda: torch.sort(pids, stable=True)),
        shape=f"mesh q3: {n24} rows in, {k24_p * n24} out, {len(k24_cols)} leaves "
              f"({widths - 1} B a row), {len(k24_keys)} key limbs, {k24_p} shards",
        # every device event of the call: its frames' zeroing memsets too
        device_us=device_us(lambda: kernels.mesh_bucketize(k24_cols, k24_valid, k24_keys, k24_p),
                            iters=5),
        per_query={p: v["K24"] for p, v in launches_by.items()})
    del pids

    (ranks, valid, p), _ = cap.args["K14"]
    (ranks5, valid5, p5), _ = cap.args["K14 q5"]
    n = valid.shape[0]
    r = np.random.default_rng(seed + 14)
    cases = [("Q3's largest call", ranks, valid)]
    for label in ("duplicate build keys", "no matches", "all invalid"):
        keys = r.integers(0, n // 4, n)
        if label == "no matches":
            keys[p:] = r.integers(n, 2 * n, n - p)
        v = torch.from_numpy(np.zeros(n, bool) if label == "all invalid"
                             else r.random(n) < 0.9).to(dev)
        cases.append((label, kernels.dense_rank([torch.from_numpy(keys).to(dev)], v)[0], v))
    cases.append(("Q5's largest call", ranks5, valid5, p5))
    for label, rk, v, *pp in cases:
        pc = pp[0] if pp else p
        got = join.pk_match_ranks(rk, v, pc)
        exp = join._pk_match_plain(rk, v, pc)
        torch.cuda.synchronize()
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, exp)):
            fail(f"K14 {label}: build rows or matches differ from the plain version")
        print(f"K14 {label}: {pc} probe + {v.shape[0] - pc} build rows, {int(got[1].sum())} "
              "matched: matches the plain version")
    k14 = dict(
        name="K14 rank PK match", route="cuda", source="quokka_tpu_torch/csrc/join.cu",
        replaces="quokka_tpu/ops/join.py:129", launches=launches_by["mesh q3"]["K14"],
        max_abs_err=0.0, ms=cuda_ms(lambda: join.pk_match_ranks(ranks, valid, p)),
        plain_ms=cuda_ms(lambda: join._pk_match_plain(ranks, valid, p)),
        bound_ms=bound_ms(nbytes(ranks, valid) + 5 * p), bound_by="bytes", library_ms=None,
        shape=f"mesh q3: {p} probe + {n - p} build rows (one shard)",
        device_us=device_us(lambda: join.pk_match_ranks(ranks, valid, p)),  # the memset too
        per_query={q: v["K14"] for q, v in launches_by.items()},
        q5=dict(launches=launches_by["mesh q5"]["K14"],
                ms=cuda_ms(lambda: join.pk_match_ranks(ranks5, valid5, p5)),
                plain_ms=cuda_ms(lambda: join._pk_match_plain(ranks5, valid5, p5)),
                bound_ms=bound_ms(nbytes(ranks5, valid5) + 5 * p5),
                device_us=device_us(lambda: join.pk_match_ranks(ranks5, valid5, p5)),
                shape=f"mesh q5: {p5} probe + {valid5.shape[0] - p5} build rows (one shard)"))
    return [k24, k14]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def rank_plan_rows(dev, plans, launches_by_path, skewed, seed: int):
    """K10's and K13p's rows of the per-kernel table: each kernel against its
    plain version bit for bit at the queries' largest plans (``plans``: path
    -> (limbs, valid, probe rows) of Q4's, Q13's and Q21's) and on made
    inputs, the radix sort under both against its plain version index for
    index, then each timed whole and by part (range and pack passes, digit
    passes, rank pass, fill), beside its plain version, its bound and one
    stable torch.sort of the valid rows' packed key (the library column: a
    yardstick, not the same function)."""
    import torch
    from quokka_tpu_torch.ops import join, kernels

    # K10 and K13p, each against its plain version bit for bit: at Q4's plan
    # (its semi join, one int64 limb), Q13's plan (its left join) and Q21's
    # largest anti-join plan (two int64 limbs), at K13's skewed case (one
    # probe key matching 10^4 build rows), and on made inputs: float64 limbs
    # with -0.0, +0.0 and NaN, float32 and bool limbs, every row invalid, row
    # counts that are not a multiple of the 4096-row tile, strided limbs and
    # validity.  Each plan is checked in both modes (with build positions,
    # and the semi / anti joins' counts only).
    (q4_l, q4_v, q4_p), (q13_l, q13_v, q13_p), (q21_l, q21_v, q21_p) = (
        plans["q4"], plans["q13"], plans["q21"])
    s_limbs, s_valid, p_s = skewed
    if len(q21_l) != 2:
        fail(f"Q21's largest anti-join plan has {len(q21_l)} limbs, expected 2")

    def same_bits(label, got, want):
        for i, (x, y) in enumerate(zip(got, want)):
            if x.dtype != y.dtype or not torch.equal(x.reshape(-1), y.reshape(-1)):
                fail(f"{label}: output {i} differs from the plain version")

    def check_k10_k13p(label, limbs, valid, p):
        same_bits(f"K10 {label}", kernels._dense_rank_cuda(limbs, valid),
                  kernels.dense_rank_plain(limbs, valid))
        same_bits(f"K13p {label}", join._mm_plan_cuda(limbs, valid, p),
                  join._mm_plan_plain(limbs, valid, p))
        same_bits(f"K13p {label}, counts", join._mm_plan_cuda(limbs, valid, p, False)[:1],
                  join._mm_counts_plain(limbs, valid, p)[:1])
        torch.cuda.synchronize()
        print(f"K10 and K13p {label}: {valid.shape[0]} rows ({int(valid.sum())} valid, {p} "
              f"probe), {len(limbs)} limbs {[str(l.dtype) for l in limbs]}: bit for bit")

    g10 = torch.Generator(device="cpu").manual_seed(seed + 10)
    n10 = 3 * (1 << 16) + 123
    f10 = torch.randint(-4, 4, (n10,), generator=g10).to(torch.float64)
    u10 = torch.rand(n10, generator=g10)
    f10[u10 < 0.1] = float("nan")
    f10[(u10 >= 0.1) & (u10 < 0.3)] = -0.0
    v10 = torch.rand(n10, generator=g10) < 0.9
    i10 = torch.randint(0, 1 << 12, (n10,), generator=g10)
    wide = torch.stack([i10, torch.randint(0, 7, (n10,), generator=g10)], 1).to(dev)
    vwide = torch.stack([v10, ~v10], 1).to(dev)
    cases10 = [
        ("at Q4's plan", q4_l, q4_v, q4_p), ("at Q13's plan", q13_l, q13_v, q13_p),
        ("at Q21's largest anti-join plan", q21_l, q21_v, q21_p),
        ("one probe key x 10^4 build rows", s_limbs, s_valid, p_s),
        ("float64 with -0.0, +0.0 and NaN", [f10.to(dev)], v10.to(dev), n10 // 3),
        ("float32 and bool limbs", [f10.to(torch.float32).to(dev), (i10 % 2 == 0).to(dev)],
         v10.to(dev), 1000),
        ("int64 and int32 limbs, 100,003 rows",
         [i10[:100_003].to(dev), (i10[:100_003] % 5).to(torch.int32).to(dev)],
         v10[:100_003].to(dev), 50_001),
        ("every row invalid", [i10.to(dev)], torch.zeros(n10, dtype=torch.bool, device=dev),
         n10 // 2),
        ("no valid build row", [i10.to(dev)], torch.cat([v10[:1000], torch.zeros(
            n10 - 1000, dtype=torch.bool)]).to(dev), 1000),
        ("strided limbs and validity", [wide[:, 0], wide[:, 1]], vwide[:, 0], n10 // 4)]
    for label, limbs, valid, p in cases10:
        check_k10_k13p(label, limbs, valid, p)

    # the radix sort under both, index for index against its plain version
    # (the valid prefix _sort_perm's, the invalid rows in row order) at the
    # three plans, on a key of two words, and on float limbs
    g17 = torch.Generator(device="cpu").manual_seed(seed + 17)
    n17 = (1 << 20) + 17
    two_words = [torch.randint(-(1 << 40), 1 << 40, (n17,), generator=g17).to(dev),
                 torch.randint(-(1 << 45), 1 << 45, (n17,), generator=g17).to(dev)]
    v17 = (torch.rand(n17, generator=g17) < 0.8).to(dev)
    sort_cases = [("at Q4's plan", q4_l, q4_v), ("at Q13's plan", q13_l, q13_v),
                  ("at Q21's largest anti-join plan", q21_l, q21_v),
                  ("two int64 limbs over two words", two_words, v17),
                  ("float64 and float32 with -0.0, +0.0 and NaN",
                   [f10.to(dev), f10.to(torch.float32).to(dev)], v10.to(dev))]
    sort_info = {}
    for label, limbs, valid in sort_cases:
        got = kernels.sort_perm(limbs, valid)
        want = kernels.sort_perm_plain(limbs, valid)
        nv = int(valid.sum())
        if not torch.equal(got, want) or not torch.equal(
                got[:nv], kernels._sort_perm(limbs, valid)[:nv]):
            fail(f"radix sort {label}: its permutation differs from the plain version")
        _, words, bits = kernels.pack_keys_plain(limbs, valid)
        if label.startswith("two int64") and len(words) != 2:
            fail(f"radix sort {label}: {len(words)} key words, expected 2")
        sort_info[label] = {"rows": valid.shape[0], "valid": nv, "key_bits": bits,
                            "key_words": len(words)}
        print(f"radix sort {label}: {valid.shape[0]} rows ({nv} valid), {len(limbs)} limbs "
              f"packed into {bits} key bits in {len(words)} words: index for index")

    parts = {"range_pack": ("qk_sort_range_kernel", "qk_sort_pack_kernel"),
             "digits": ("qk_sort_digit_kernel",), "pass": ("qk_rank_kernel",),
             "fill": ("qk_mm_fill_kernel",)}

    def split_us(fn):
        """(whole call, {part: device us}) a call: every device operation of
        the call; "other" is the memset."""
        per = {}
        for _ in range(2):
            # the profiler drops records in a long process: of two windows,
            # the one that kept more device time
            got, _ = kernel_us(fn, expect=("qk_rank_kernel", "qk_sort_pack_kernel",
                                           "qk_sort_digit_kernel"))
            if sum(got.values()) > sum(per.values()):
                per = got
        split = {part: sum(t for k, t in per.items() if k.startswith(names))
                 for part, names in parts.items()}
        split["other"] = sum(per.values()) - sum(split.values())
        return sum(per.values()), split

    def yardstick_ms(limbs, valid):
        """One stable torch.sort of the valid rows' packed key, its first
        word (the whole key where it fits one): a yardstick, not the same
        function."""
        _, words, _ = kernels.pack_keys_plain(limbs, valid)
        key = words[0] if words else torch.zeros(int(valid.sum()), dtype=torch.int64, device=dev)
        return cuda_ms(lambda: torch.sort(key, stable=True))

    def rank_bytes(limbs, valid):
        return nbytes(*limbs, valid) + valid.shape[0] * 8 + 4

    def plan_bytes(limbs, valid, p, with_bps):
        n = valid.shape[0]
        return nbytes(*limbs, valid) + 8 * ((p + 1 + 2 * n) if with_bps else p)

    def k10_at(limbs, valid, path):
        fn = lambda: kernels.dense_rank(limbs, valid)
        whole, split = split_us(fn)
        return dict(launches=launches_by_path[path]["K10"], ms=cuda_ms(fn),
                    plain_ms=cuda_ms(lambda: kernels.dense_rank_plain(limbs, valid), iters=5),
                    bound_ms=bound_ms(rank_bytes(limbs, valid)), device_us=whole,
                    split_device_us=split, library_ms=yardstick_ms(limbs, valid),
                    shape=f"{path}'s plan: {valid.shape[0]} rows, {len(limbs)} limbs "
                          f"{[str(l.dtype) for l in limbs]}")

    def k13p_at(limbs, valid, p, path, with_bps):
        fn = ((lambda: join._mm_plan(limbs, valid, p)) if with_bps
              else (lambda: join._mm_counts(limbs, valid, p)))
        plain = ((lambda: join._mm_plan_plain(limbs, valid, p)) if with_bps
                 else (lambda: join._mm_counts_plain(limbs, valid, p)))
        whole, split = split_us(fn)
        return dict(launches=launches_by_path[path]["K13p"], ms=cuda_ms(fn),
                    plain_ms=cuda_ms(plain, iters=5),
                    bound_ms=bound_ms(plan_bytes(limbs, valid, p, with_bps)), device_us=whole,
                    split_device_us=split, library_ms=yardstick_ms(limbs, valid),
                    shape=f"{path}'s plan: {p} probe + {valid.shape[0] - p} build rows, "
                          f"{len(limbs)} limbs, "
                          + ("with build positions" if with_bps else "counts only"))

    def per_query(kernel):
        return {p: n[kernel] for p, n in launches_by_path.items() if n[kernel]}

    def show(name, at):
        sp = at["split_device_us"]
        print(f"{name} {at['shape']}: {at['device_us']:.1f} device us (range+pack "
              f"{sp['range_pack']:.1f}, digit passes {sp['digits']:.1f}, rank pass "
              f"{sp['pass']:.1f}, fill {sp['fill']:.1f}, memset {sp['other']:.1f}), "
              f"{at['ms']:.4f} ms, plain {at['plain_ms']:.4f} ms, bound {at['bound_ms']:.5f} ms, "
              f"torch.sort of the packed key {at['library_ms']:.4f} ms")

    out = []
    row10 = k10_at(q4_l, q4_v, "q4")
    out.append(dict(
        name="K10 dense rank (radix sort of the valid rows, then one pass over the sorted keys)",
        route="cuda", source="quokka_tpu_torch/csrc/rank.cu",
        replaces="quokka_tpu/ops/kernels.py:138", max_abs_err=0.0, bound_by="bytes",
        per_query=per_query("K10"), sort_cases=sort_info,
        **row10, q13=k10_at(q13_l, q13_v, "q13"), q21=k10_at(q21_l, q21_v, "q21")))
    row13 = k13p_at(q13_l, q13_v, q13_p, "q13", True)
    out.append(dict(
        name="K13p many-to-many plan (the radix sort, K10's pass in plan mode and the fill)",
        route="cuda", source="quokka_tpu_torch/csrc/rank.cu",
        replaces="quokka_tpu/ops/join.py:220", max_abs_err=0.0, bound_by="bytes",
        per_query=per_query("K13p"),
        **row13, q4=k13p_at(q4_l, q4_v, q4_p, "q4", False),
        q21=k13p_at(q21_l, q21_v, q21_p, "q21", False),
        skew=k13p_at(s_limbs, s_valid, p_s, "q13", True)))
    out[-1]["skew"].update(launches=0, shape="one probe key x 10^4 build rows: "
                           + out[-1]["skew"]["shape"].split(": ", 1)[1])
    for row, short in ((out[0], "K10"), (out[1], "K13p")):
        show(short, row)
        for key in ("q4", "q13", "q21", "skew"):
            if key in row:
                show(short, row[key])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout (the parent commit): Q1, Q3 and Q5 are "
                         "run through it and through this one in turns, in subprocesses")
    ap.add_argument("--walls-only", action="store_true",
                    help="only time Q1, Q3 and Q5 through the package in --package and "
                         "print one JSON line (what --parent runs)")
    ap.add_argument("--walls-paths", default=",".join(COMPARED),
                    help="with --walls-only: the paths to time, comma-separated, of q1, q3, "
                         "q5, q13, q7, tumbling, hopping, session, sliding, shift, vector "
                         "and ann")
    ap.add_argument("--package", default=str(ROOT))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    if not (ROOT / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no quokka_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    if args.walls_only:
        return walls_only(args)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "quokka_tpu_torch" / "triton"))
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    return smoke(torch.device("cuda", 0), card, args)


def smoke(dev, card: str, args) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quokka_tpu_torch import QuokkaContext, col, config, date, obs, sqlparse
    from quokka_tpu_torch.dataset import vector as dvec
    from quokka_tpu_torch.dataset.readers import InputArrowDataset
    from quokka_tpu_torch.executors import ts_execs
    from quokka_tpu_torch.executors.sql_execs import PartialAggExecutor
    from quokka_tpu_torch.ops import asof, bridge, fuse, hashtable, join, kernels, native
    from quokka_tpu_torch.ops import linalg as lops
    from quokka_tpu_torch.obs import devprof, explain
    from quokka_tpu_torch.ops import pack, stagefuse, strategy
    from quokka_tpu_torch.ops import vector as vops
    from quokka_tpu_torch.ops.batch import key_limbs
    from quokka_tpu_torch.ops.expr_compile import plan_aggregation
    from quokka_tpu_torch.runtime import engine as engine_mod

    for mod in ("jax", "quokka_tpu", "pyarrow", "pandas"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    # -- phase 1: the card -----------------------------------------------------
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "seed": args.seed, "sf": args.sf}

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    native.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s (nvcc, {len(native.SOURCES)} sources in parallel)")
    report["build_s"] = build_s

    # -- phase 3: data ------------------------------------------------------------
    t0 = time.perf_counter()
    tables = make_tpch(args.sf, args.seed)
    li = tables["lineitem"]
    oracles = {"q1": q1_oracle(li), "q3": q3_oracle(tables), "q5": q5_oracle(tables),
               "q4": q4_oracle(tables), "q13": q13_oracle(tables),
               "q19": q19_oracle(tables), "q7": q7_oracle(tables), "q21": q21_oracle(tables)}
    ticks = make_ticks(args.sf, args.seed)
    oracles.update(asof=asof_oracle(ticks, "backward"),
                   **{"asof forward": asof_oracle(ticks, "forward")}, **window_oracles(ticks))
    oracles["dryrun q3 shape"] = dryrun_q3_oracle(tables)
    oracles["dryrun asof shape"] = asof_oracle(ticks, "backward", value="size")
    skew = make_skewjoin(args.sf, args.seed)
    oracles["skewjoin"] = skewjoin_oracle(skew)
    report["datagen_s"] = time.perf_counter() - t0
    report["rows"] = {name: t.num_rows for name, t in tables.items()}
    report["rows"].update({name: len(c["time"]) for name, c in ticks.items()})
    report["rows"].update({f"skew {name}": t.num_rows for name, t in skew.items()})
    print(f"data sf={args.sf}: {report['rows']} in {report['datagen_s']:.1f} s "
          "(with the oracles)")

    # the vector tier's data: the corpus as Arrow, the ANN file as Parquet
    # with its IVF sidecar (built on the card), and the float64 oracles
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    vd = make_vectors(args.sf, args.seed)
    corpus = vector_table(vd["vecs"], vd["null"])
    ann_dir = ROOT / "build" / "chip_smoke"
    ann_dir.mkdir(parents=True, exist_ok=True)
    ann_path = str(ann_dir / "ann.parquet")
    rg_rows = len(vd["ann"]) // ANN_ROW_GROUPS
    # the file's null rows are written as the zero vectors they become on the
    # device: pyarrow reads no Parquet fixed_size_list column with nulls back
    # ("Expected all lists to be of size=100 but index 90 had size=0")
    pq.write_table(vector_table(vd["ann"], np.zeros(len(vd["ann"]), dtype=bool)), ann_path,
                   row_group_size=rg_rows)
    report["vector_datagen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dvec.build_vector_index(ann_path, "emb", n_cells=ANN_CELLS, device=dev)
    torch.cuda.synchronize()
    report["ann_index_s"] = time.perf_counter() - t0
    ann_q = vd["queries"][:ANN_QUERIES]
    ann_keep = prune_numpy(dvec.sidecar_path(ann_path), ann_q, ANN_NPROBE)
    ann_rows = np.concatenate([np.arange(g * rg_rows, (g + 1) * rg_rows) for g in ann_keep])
    t0 = time.perf_counter()
    oracles["vector"] = topk_oracle(dev, vd["vecs"], vd["queries"], VEC_K)
    a_s, a_i = topk_oracle(dev, vd["ann"][ann_rows], ann_q, VEC_K)
    oracles["ann"] = (a_s, ann_rows[a_i])
    # the card's float64 oracle against numpy's on 32 sampled queries
    pick = np.random.default_rng(args.seed).choice(VEC_QUERIES, 32, replace=False)
    n_s, n_i = topk_numpy(vd["vecs"], vd["queries"][pick], VEC_K)
    o_s, o_i = oracles["vector"][0][pick], oracles["vector"][1][pick]
    tie = n_s[:, VEC_K - 1] - n_s[:, VEC_K] <= 1e-12
    if np.abs(n_s[:, :VEC_K] - o_s[:, :VEC_K]).max() > 1e-12 or (
            ~tie & ~(np.sort(n_i[:, :VEC_K], 1) == np.sort(o_i[:, :VEC_K], 1)).all(1)).any():
        fail("the card's float64 top-k oracle differs from numpy's on sampled queries")
    oracles["gramian"] = gram_oracle(li, False)
    oracles["covariance"] = gram_oracle(li, True)
    oracles["quantile"] = np.quantile(li.cols["l_extendedprice"], QUANTILES)
    report["vector_oracles_s"] = time.perf_counter() - t0
    near = oracles["vector"][0][:, VEC_K - 1] - oracles["vector"][0][:, VEC_K] <= VEC_TIE_TOL
    report["vector_data"] = {"rows": len(vd["vecs"]), "dim": VEC_DIM,
                             "queries": VEC_QUERIES, "k": VEC_K,
                             "null_rows": int(vd["null"].sum()),
                             "queries_with_near_tie": int(near.sum()),
                             "ann_rows": len(vd["ann"]), "ann_row_groups_kept": ann_keep.tolist()}
    print(f"vector data: {len(vd['vecs'])} x {VEC_DIM} ({int(vd['null'].sum())} null), "
          f"{VEC_QUERIES} queries, in {report['vector_datagen_s']:.1f} s; ANN file "
          f"{len(vd['ann'])} rows in {ANN_ROW_GROUPS} row groups, IVF index "
          f"{report['ann_index_s']:.2f} s, {len(ann_keep)} row groups kept for "
          f"{ANN_QUERIES} queries at nprobe {ANN_NPROBE}; oracles "
          f"{report['vector_oracles_s']:.1f} s ({int(near.sum())} queries with a near tie)")
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)

    def src(name):
        # a reader per source: it holds the source's pushed-down projection
        reader = TableReader(tables[name])
        return ctx.read_dataset(reader, schema=reader.schema)

    def q1_stream():
        return tpch_stream("q1", ctx, tables)

    def q3_stream():
        return tpch_stream("q3", ctx, tables)

    def q5_stream():
        return tpch_stream("q5", ctx, tables)

    def q4_stream():
        return tpch_stream("q4", ctx, tables)

    def q13_stream():
        return tpch_stream("q13", ctx, tables)

    def q19_stream():
        return (src("lineitem").join(src("part"), left_on="l_partkey", right_on="p_partkey")
                .filter_sql(Q19_FILTER)
                .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue, count(*) as n"))

    def asof_stream(direction="backward"):
        return tick_stream("asof forward" if direction == "forward" else "asof", ctx, ticks)

    def tumbling_stream():
        return tick_stream("tumbling", ctx, ticks)

    def hopping_stream():
        return tick_stream("hopping", ctx, ticks)

    def session_stream():
        return tick_stream("session", ctx, ticks)

    sliding_aggs = SLIDING_AGGS

    def sliding_stream():
        return tick_stream("sliding", ctx, ticks)

    def shift_stream():
        return tick_stream("shift", ctx, ticks)

    def q7_stream():
        return tpch_stream("q7", ctx, tables)

    def q21_stream():
        return tpch_stream("q21", ctx, tables)

    def vector_stream():
        # glove-100-angular's shape: 2^20-row batches of an Arrow corpus
        return ctx.read_dataset(InputArrowDataset(corpus, batch_rows=BATCH_ROWS)) \
            .nearest_neighbors(vd["queries"], "emb", VEC_K)

    def ann_stream():
        return ctx.read_parquet(ann_path).nearest_neighbors(
            ann_q, "emb", VEC_K, approximate=True, nprobe=ANN_NPROBE)

    def gramian_stream():
        return src("lineitem").select(LINALG_COLS).gramian(LINALG_COLS)

    def covariance_stream():
        return src("lineitem").select(LINALG_COLS).covariance(LINALG_COLS)

    def quantile_stream():
        return src("lineitem").select(["l_extendedprice"]).approximate_quantile(
            "l_extendedprice", QUANTILES)

    def skewjoin_stream():
        # bench.py's build_skewjoin, in its 8,192-row batches
        def side(name):
            reader = TableReader(skew[name], batch_rows=SKEW_BATCH)
            return ctx.read_dataset(reader, schema=reader.schema)

        return (side("probe").join(side("build"), left_on="pk", right_on="k")
                .groupby("g").agg_sql("sum(v) as sv, count(*) as n"))

    vec_stats = {}

    def check_vector(got, exp):
        vec_stats["vector"] = check_topk("vector", got, *exp, VEC_K)

    def check_ann(got, exp):
        g = ctx.latest_graph
        kept = sorted(
            g.store.tget("LT", (a.id, ch, seq))[1]
            for a in g.actors.values() if a.kind == "input" for ch in range(a.channels)
            for seq in range(g.store.tget("LIT", (a.id, ch), -1) + 1))
        if kept != ann_keep.tolist():
            fail(f"ann: the scan kept row groups {kept}, numpy's pruning {ann_keep.tolist()}")
        vec_stats["ann"] = check_topk("ann", got, *exp, VEC_K)

    counters = {"K1": (fuse, "PREDICATE_LAUNCHES"), "K2": (fuse, "SMALL_AGG_LAUNCHES"),
                "K2 pre": (fuse, "SMALL_PRE_LAUNCHES"),
                "K3": (hashtable, "LAUNCHES"), "K4": (kernels, "PARTITION_LAUNCHES"),
                "K5": (fuse, "PRE_AGG_LAUNCHES"),
                "K11 build": (hashtable, "BUILD_LAUNCHES"),
                "K11": (hashtable, "PROBE_LAUNCHES"),
                "K12": (join, "SORTED_PROBE_LAUNCHES"),
                "K13": (join, "EXPAND_LAUNCHES"),
                "K16": (stagefuse, "ELEMWISE_LAUNCHES"),
                "K18": (asof, "ASOF_PROBE_LAUNCHES"), "K19": (asof, "FILL_FORWARD_LAUNCHES"),
                "K19 bounds": (asof, "SEGMENT_BOUNDS_LAUNCHES"),
                "K20a": (ts_execs, "WINDOW_BOUNDS_LAUNCHES"),
                "K20b": (ts_execs, "RANGE_MINMAX_LAUNCHES"),
                "K21": (vops, "LAUNCHES"), "K22": (lops, "LAUNCHES"),
                "K6": (fuse, "ONEHOT_LAUNCHES"), "K17": (kernels, "PLAN_LAUNCHES"),
                "K26": (kernels, "ADAPT_LAUNCHES"), "K23": (pack, "LAUNCHES"),
                "K24": (kernels, "MESH_LAUNCHES"), "K14": (join, "PK_MATCH_LAUNCHES"),
                "K8": (bridge, "CONCAT_LAUNCHES"), "K10": (kernels, "RANK_LAUNCHES"),
                "K13p": (join, "MM_PLAN_LAUNCHES")}
    # K18's and K12's launches that took the runtime-dispatch kernel: none on
    # any path (the main paths' signatures are compiled typed)
    dispatch_counters = {"K18": (asof, "ASOF_PROBE_DISPATCH_LAUNCHES"),
                         "K12": (join, "SORTED_PROBE_DISPATCH_LAUNCHES")}
    ts_kernels = ["K18", "K19", "K19 bounds", "K20a", "K20b"]
    # path: (stream, check, kernels it must launch, kernels it must not, and
    # whether it must take the general join).  Q4's semi join takes the
    # general join's plan but never expands, so it launches no K13.
    paths = {
        "q1": (q1_stream, check_q1, ["K1", "K2", "K3", "K4"],
               ["K5", "K11", "K12", "K13", "K16"], False),
        "q3": (q3_stream, check_q3, ["K1", "K3", "K4", "K5", "K11 build", "K11"],
               ["K12", "K13", "K16"], False),
        "q3 sort": (q3_stream, check_q3, ["K1", "K3", "K4", "K5", "K12"],
                    ["K11 build", "K11", "K13", "K16"], False),
        "q5": (q5_stream, check_q5, ["K1", "K2", "K3", "K4", "K11 build", "K11"],
               ["K12", "K13", "K16"], False),
        "q4": (q4_stream, check_q4, ["K1", "K2", "K3", "K4", "K11 build", "K10", "K13p"],
               ["K11", "K12", "K13", "K16"], True),
        "q13": (q13_stream, check_q13, ["K1", "K3", "K4", "K5", "K11 build", "K13", "K10",
                                        "K13p"], ["K11", "K12", "K16"], True),
        "q19": (q19_stream, check_q19, ["K4", "K5", "K11 build", "K11", "K16"],
                ["K12", "K13"], False),
        "q7": (q7_stream, check_q7, ["K1", "K3", "K4", "K5", "K11 build", "K11", "K16"],
               ["K12", "K13"], False),
        # three distincts over lineitem: each a group-by with no aggregates
        # (K3) and, from a channel's second batch on, an anti join against
        # the keys seen (the general join's plan, K10's pass and K13p)
        "q21": (q21_stream, check_q21, ["K1", "K3", "K4", "K11 build", "K11", "K10", "K13p"],
                ["K12", "K13"], True),
        # the time-series tier over bench.py's ticks
        "asof": (asof_stream, check_asof, ["K18", "K4"], ["K19", "K19 bounds", "K20a", "K20b"],
                 False),
        "asof sort": (asof_stream, check_asof, ["K19", "K4"],
                      ["K18", "K19 bounds", "K20a", "K20b"], False),
        "asof forward": (lambda: asof_stream("forward"), check_asof, ["K18", "K4"],
                         ["K19", "K19 bounds", "K20a", "K20b"], False),
        "tumbling": (tumbling_stream, check_tumbling, ["K3", "K4"], ts_kernels, False),
        "hopping": (hopping_stream, check_hopping, ["K3", "K4"], ts_kernels, False),
        "session": (session_stream, check_session, ["K3", "K4"], ts_kernels, False),
        "sliding": (sliding_stream, check_sliding, ["K19 bounds", "K20a", "K20b", "K4"],
                    ["K18", "K19"], False),
        "shift": (shift_stream, check_shift, ["K19 bounds", "K4"],
                  ["K18", "K19", "K20a", "K20b"], False),
    }
    for name, p in paths.items():
        # no earlier path runs the vector tier's kernels, nor slice 6's: the
        # adaptive exchange, on by default, must not fire on them; the
        # engine never runs the mesh's K24 and K14.  On Q21 the trigger may
        # fire: a final aggregate's channel delivers all its rows to one
        # build channel of the next join (both hash the order key), and
        # while the other channel's rows have not come, that channel holds
        # twice the mean (QK_SKEW_RATIO 2.0 at two channels)
        p[3].extend(["K21", "K22", "K6", "K17", "K24", "K14"]
                    + ([] if name == "q21" else ["K26"]))

    def all_but(*keep):
        # K23 lands every batch and K8 joins every compacting concat, on
        # any path (their own gates count them)
        return [k for k in counters if k not in keep and k not in ("K23", "K8")]

    # the vector, linear-algebra and quantile tier: pass-through exchanges
    # only, so no kernel but its own (the quantiles' t-digest runs on the host)
    paths.update({
        "vector": (vector_stream, check_vector, ["K21"], all_but("K21"), False),
        "ann": (ann_stream, check_ann, ["K21"], all_but("K21"), False),
        "gramian": (gramian_stream, lambda g, e: check_gram("gramian", g, e), ["K22"],
                    all_but("K22"), False),
        "covariance": (covariance_stream, lambda g, e: check_gram("covariance", g, e),
                       ["K22"], all_but("K22"), False),
        "quantile": (quantile_stream, check_quantiles, [], all_but(), False),
    })
    # the exchange and strategy rows: the compacted shuffle (K17), forced
    # and past a lowered masked-split cap; bench.py's skew join, adaptive
    # (K26) and static; groupby=sort's one-hot partial aggregate (K6)
    # kernels of the time-series tier and of the mesh
    ts_only = ["K18", "K19", "K19 bounds", "K20a", "K20b", "K24", "K14"]
    sort_must_not = ["K2", "K2 pre", "K17", "K26", "K12", "K21", "K22"] + ts_only
    paths.update({
        "q3 compacted": (q3_stream, check_q3, ["K1", "K3", "K4", "K5", "K11 build", "K11",
                                               "K17"], [k for k in paths["q3"][3] if k != "K17"],
                         False),
        "q5 compacted": (q5_stream, check_q5, ["K1", "K2", "K3", "K4", "K11 build", "K11",
                                               "K17"], [k for k in paths["q5"][3] if k != "K17"],
                         False),
        "q7 compacted": (q7_stream, check_q7, ["K1", "K3", "K4", "K5", "K11 build", "K11",
                                               "K16", "K17"],
                         [k for k in paths["q7"][3] if k != "K17"], False),
        "q3 cap": (q3_stream, check_q3, ["K1", "K3", "K4", "K5", "K11 build", "K11", "K17"],
                   [k for k in paths["q3"][3] if k != "K17"], False),
        "skewjoin": (skewjoin_stream, check_skewjoin, ["K4", "K26", "K13"],
                     ["K6", "K17", "K12", "K21", "K22"] + ts_only, True),
        "skewjoin static": (skewjoin_stream, check_skewjoin, ["K4", "K13"],
                            ["K6", "K17", "K26", "K12", "K21", "K22"] + ts_only, True),
        "q1 sort": (q1_stream, check_q1, ["K1", "K4", "K5", "K6"], sort_must_not, False),
        "q4 sort": (q4_stream, check_q4, ["K1", "K4", "K5", "K6", "K11 build"],
                    sort_must_not, True),
        "q5 sort": (q5_stream, check_q5, ["K1", "K4", "K5", "K11 build", "K11"],
                    sort_must_not, False),
    })
    # every batch of every path lands through the wire decode (K23), and
    # every path but the linear-algebra and quantile ones joins its
    # exchanged parts by a compacting concat (K8)
    no_concat = {"gramian", "covariance", "quantile"}
    paths = {k: (st, ch, must + ["K23"] + ([] if k in no_concat else ["K8"]), mn, g)
             for k, (st, ch, must, mn, g) in paths.items()}
    compacted_paths = {"q3 compacted", "q5 compacted", "q7 compacted", "q3 cap"}
    sort_paths = {"q1 sort", "q4 sort", "q5 sort"}
    ts_paths = ["asof", "asof sort", "asof forward", "tumbling", "hopping", "session",
                "sliding", "shift"]
    # each path's knobs: the strategy rows it forces, the skew join's trigger
    # settings (bench.py's), and the masked-split cap (set on config, which
    # reads QUOKKA_SHUFFLE_MASKED_CAP at import, as bench.py sets its knobs)
    path_env = {"q3 sort": {"QK_KERNEL_STRATEGY": "join_build=sort"},
                "asof sort": {"QK_KERNEL_STRATEGY": "asof=sort"},
                **{p: {"QK_KERNEL_STRATEGY": "shuffle=compacted"}
                   for p in compacted_paths if p != "q3 cap"},
                "skewjoin": dict(SKEW_ENV), "skewjoin static": {**SKEW_ENV, "QK_ADAPT": "0"},
                **{p: {"QK_KERNEL_STRATEGY": "groupby=sort"} for p in sort_paths}}
    env_keys = ("QK_KERNEL_STRATEGY", "QK_ADAPT", "QK_SKEW_RATIO", "QK_ADAPT_MIN_ROWS")
    default_cap = config.SHUFFLE_MASKED_CAP
    masked_cap = {"q3 cap": 1 << 20}
    oracle_of = {"q3 sort": "q3", "asof sort": "asof", "q3 compacted": "q3",
                 "q5 compacted": "q5", "q7 compacted": "q7", "q3 cap": "q3",
                 "skewjoin static": "skewjoin", "q1 sort": "q1", "q4 sort": "q4",
                 "q5 sort": "q5"}
    # one warm run where the check is cheap; the per-row outputs (6M rows)
    # are held against the oracle on the cold run and counted on the warm ones
    warm_runs = {"q3 sort": 1, "asof sort": 1, "vector": 2, "ann": 2,
                 **{p: 2 for p in ts_paths if p != "asof sort"},
                 **{p: 2 for p in compacted_paths | sort_paths},
                 "skewjoin": 3, "skewjoin static": 3}
    per_row = {"sliding", "shift"}
    plan_text = {}
    launches_by_path, walls, concat_calls, sort_calls = {}, {}, {}, {}
    slice6 = {}  # what the slice-6 paths showed: syncs, ADT records, one-hot batches

    def set_strategy(path=None):
        for k in env_keys:
            os.environ.pop(k, None)
        os.environ.update(path_env.get(path, {}))
        config.SHUFFLE_MASKED_CAP = masked_cap.get(path, default_cap)

    # -- phase 4: the query paths ------------------------------------------------
    real_general = join.hash_join_general
    general_calls = []

    def counted_general(*a, **kw):
        general_calls.append(kw.get("how", a[4] if len(a) > 4 else "inner"))
        return real_general(*a, **kw)

    real_put, real_dims = engine_mod.BatchCache.put, fuse.FusedPartialAgg._small_dims
    delivered, onehot_batches = {}, []

    def counted_put(self, name, batch):
        # rows each (edge, target channel) received: the skew join's spread
        src_a, _sch, _seq, tgt_a, _, tgt_ch = name
        key = (src_a, tgt_a, tgt_ch)
        delivered[key] = delivered.get(key, 0) + batch.count_valid()
        return real_put(self, name, batch)

    def recorded_dims(self, batch, use_tables=True):
        # which path each groupby=sort partial aggregate took, and why
        dims = real_dims(self, batch, use_tables)
        if not use_tables:
            onehot_batches.append((batch.padded_len, None if dims is None
                                   else int(np.prod(dims)) + 1))
        return dims

    real_h2d, real_encode, real_stage = bridge.host_to_device, pack._encode, pack.stage
    landing = {}  # path -> landed batches, host encode / stage seconds, wire / logical bytes

    def charged():
        """devprof's dispatches on the card so far, by kernel (the plain
        versions' charges, e.g. the catalog's CPU sample landing, apart)."""
        by = {}
        for row in devprof.costs_snapshot():
            if row["device"] == "cuda":
                by[row["kernel"]] = by.get(row["kernel"], 0) + row["dispatches"]
        return by

    k2_pre_paths = {"q1", "q5", "q5 compacted"}
    for path, (stream, check, must, must_not, general) in paths.items():
        set_strategy(path)
        land = landing[path] = {"batches": 0, "encode_s": 0.0, "stage_s": 0.0,
                                "wire_bytes": 0, "logical_bytes": 0}

        def counted_h2d(table, device, *a, _land=land, **kw):
            # the batches the query lands on the card (the optimizer's
            # catalog lands its samples on the CPU)
            _land["batches"] += torch.device(device).type == "cuda"
            return real_h2d(table, device, *a, **kw)

        def timed_encode(*a, _land=land, **kw):
            t = time.perf_counter()
            try:
                return real_encode(*a, **kw)
            finally:
                _land["encode_s"] += time.perf_counter() - t

        def timed_stage(*a, _land=land, **kw):
            t = time.perf_counter()
            st = real_stage(*a, **kw)
            _land["stage_s"] += time.perf_counter() - t
            _land["wire_bytes"] += st.buf.numel()
            _land["logical_bytes"] += sum(o.numel() * o.element_size() for o in st.outs)
            return st
        exp = oracles[oracle_of.get(path, path)]
        plan_text[path] = stream().explain()
        for mod, attr in list(counters.values()) + [(fuse, "FALLBACKS"),
                                                     (stagefuse, "SEQUENTIAL"),
                                                     (kernels, "SHUFFLE_HOST_SYNCS")] \
                + list(dispatch_counters.values()):
            setattr(mod, attr, 0)
        strategy.reset_used()
        general_calls.clear()
        delivered.clear()
        onehot_batches.clear()
        join.hash_join_general = counted_general
        bridge.host_to_device, pack._encode, pack.stage = counted_h2d, timed_encode, timed_stage
        charged0 = charged()
        if path.startswith("skewjoin"):
            engine_mod.BatchCache.put = counted_put
        if path in sort_paths:
            fuse.FusedPartialAgg._small_dims = recorded_dims
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Row20Spy() as row20, ConcatSpy() as concat, PlanSortSpy() as plans:
                got = collect_numpy(stream(), path)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        finally:
            join.hash_join_general = real_general
            engine_mod.BatchCache.put = real_put
            fuse.FusedPartialAgg._small_dims = real_dims
            bridge.host_to_device, pack._encode, pack.stage = real_h2d, real_encode, real_stage
        syncs = kernels.SHUFFLE_HOST_SYNCS
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        dispatched = {k: getattr(mod, attr) for k, (mod, attr) in dispatch_counters.items()}
        # the cost gate: each kernel's devprof dispatches on this run equal
        # its launches, and K23 ran once per landed batch
        charged1 = charged()
        miscounted = {k: (n, charged1.get(k, 0) - charged0.get(k, 0))
                      for k, n in launches.items() if charged1.get(k, 0) - charged0.get(k, 0) != n}
        if miscounted:
            fail(f"{path}: launches vs devprof dispatches differ: {miscounted}")
        if launches["K23"] != land["batches"]:
            fail(f"{path}: {launches['K23']} K23 launches for {land['batches']} landed batches")
        # every compacting concat took K8, with no torch.nonzero
        concat.check(path, launches["K8"])
        concat_calls[path] = concat.calls
        # every dense rank and many-to-many plan took one radix sort, and no
        # lexsort_perm or torch.sort
        plans.check(path, launches["K10"], launches["K13p"])
        sort_calls[path] = (plans.ranks, plans.plans)
        fallbacks, sequential = fuse.FALLBACKS, stagefuse.SEQUENTIAL
        used = strategy.used_snapshot()
        check(got, exp)
        rows_out = len(next(iter(got.values())))
        launches_by_path[path] = launches
        print(f"{path} sf={args.sf}: cold {cold:.3f} s, launches {launches}, "
              f"fallbacks {fallbacks}, per-step stage batches {sequential}, general joins "
              f"{len(general_calls)} {sorted(set(general_calls))}; matches the numpy oracle")
        print(f"{path} landing: {land['batches']} batches, wire {land['wire_bytes']} B of "
              f"{land['logical_bytes']} B logical "
              f"({land['wire_bytes'] / max(land['logical_bytes'], 1):.3f}), host encode "
              f"{land['encode_s'] / max(land['batches'], 1):.5f} s and stage "
              f"{land['stage_s'] / max(land['batches'], 1):.5f} s per batch")
        missing = [k for k in must if launches[k] == 0]
        if missing:
            fail(f"kernels not launched on the {path} run: {missing}")
        # K2's pre-pass runs once a K2 call whose plan has expression inputs
        # (Q1's and Q5's), and never on a plan of plain columns and count(*)
        # (the as-of paths' sum(notional), count(*); Q4's count(*))
        want_pre = launches["K2"] if path in k2_pre_paths else 0
        if launches["K2 pre"] != want_pre:
            fail(f"{path}: {launches['K2 pre']} K2 pre-pass launches for {launches['K2']} K2 "
                 f"calls, expected {want_pre}")
        stray = [k for k in must_not if launches[k] != 0]
        if stray:
            fail(f"kernels launched on the {path} run that its strategy excludes: {stray}")
        # sliding and shift take every row's segment start and end from K19's
        # segment bounds: no flip + cummin on the card
        if path in ("sliding", "shift") and (
                row20.calls or launches["K19 bounds"] != SEGMENT_BOUNDS_PER_QUERY):
            fail(f"{path}: {row20.calls} flip + cummin calls on the card and "
                 f"{launches['K19 bounds']} K19 segment bounds, expected 0 and "
                 f"{SEGMENT_BOUNDS_PER_QUERY}")
        if any(dispatched.values()):
            fail(f"{path}: sorted searches took the runtime-dispatch kernel, not the typed "
                 f"one: {dispatched}")
        if fallbacks:
            fail(f"{fallbacks} unfused fallbacks on {path}")
        if sequential:
            fail(f"{sequential} fused-stage batches took the per-step path on {path}")
        if general != bool(general_calls):
            fail(f"{path}: {len(general_calls)} general joins, expected "
                 f"{'some' if general else 'none'}")
        if path.startswith("asof"):
            want = "sort" if path == "asof sort" else "searchsorted"
            if used.get("asof") != want:
                fail(f"{path}: the asof strategy recorded is {used.get('asof')}, not {want}")
        # the shuffle's blocking reads: one per compacted split, none else
        if path in compacted_paths:
            if syncs != launches["K17"] or "compacted" not in used.get("shuffle", ""):
                fail(f"{path}: {syncs} shuffle host syncs for {launches['K17']} compacted "
                     f"splits (shuffle recorded {used.get('shuffle')})")
        elif syncs:
            fail(f"{path}: {syncs} shuffle host syncs on a masked-split run")
        if path in sort_paths:
            if used.get("groupby") != "sort":
                fail(f"{path}: the groupby strategy recorded is {used.get('groupby')}")
            taken = {}
            for padded, buckets in onehot_batches:
                what = f"K6 ({buckets} buckets)" if buckets else "general (row 10)"
                taken[f"{padded} rows: {what}"] = taken.get(f"{padded} rows: {what}", 0) + 1
            slice6[path] = {"partial_agg_batches": taken}
            print(f"{path}: partial aggregates by batch {taken}")
        if path == "q21":
            adt = dict(ctx.latest_graph.store.titems("ADT"))
            slice6[path] = {"adt": {str(k): v for k, v in adt.items()}}
            print(f"{path}: ADT {adt} (K26 launches {launches['K26']})")
        if path.startswith("skewjoin"):
            adt = dict(ctx.latest_graph.store.titems("ADT"))
            edges = {}
            for (src_a, tgt_a, ch), rows in delivered.items():
                edges.setdefault((src_a, tgt_a), {})[ch] = rows
            build = [e for e, per in edges.items()
                     if sum(per.values()) == skew["build"].num_rows]
            if len(build) != 1:
                fail(f"{path}: no single edge delivered the {skew['build'].num_rows} build rows")
            per = edges[build[0]]
            spread = max(per.values()) / (sum(per.values()) / len(per))
            slice6[path] = {"adt": {str(k): v for k, v in adt.items()},
                            "build_rows_per_channel": per, "max_over_mean": spread}
            print(f"{path}: ADT {adt}; build rows per channel {per} (max / mean {spread:.3f})")
            if path == "skewjoin":
                modes = sorted(r["mode"] for r in adt.values())
                fats = {r["fat"] for r in adt.values()}
                salted = [e for e, r in adt.items() if r["mode"] == "salt"]
                if modes != ["replicate", "salt"] or len(fats) != 1 or salted != build:
                    fail(f"skewjoin: the trigger did not fire once on the build edge: {adt}")
                if spread >= float(SKEW_ENV["QK_SKEW_RATIO"]):
                    fail(f"skewjoin: after salting a channel holds {spread:.3f} x the mean")
            elif adt:
                fail(f"skewjoin static: the trigger fired with QK_ADAPT=0: {adt}")
        warm = []
        for _ in range(warm_runs.get(path, 3)):
            t0 = time.perf_counter()
            again = collect_numpy(stream(), path)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            if path not in per_row:
                check(again, exp)
            elif len(next(iter(again.values()))) != rows_out:
                fail(f"{path}: a warm run returned another number of rows")
        walls[path] = {"cold_s": cold, "warm_s": warm}
        print(f"{path} warm: {[round(w, 4) for w in warm]} s")
    set_strategy()
    report["landing"] = landing
    q1_land = landing["q1"]
    if q1_land["wire_bytes"] * 2 > q1_land["logical_bytes"]:
        fail(f"q1: wire bytes {q1_land['wire_bytes']} are more than half the logical "
             f"{q1_land['logical_bytes']}")
    report["slice6"] = slice6
    report.update(walls=walls, launches=launches_by_path, plans=plan_text,
                  compacting_concats=concat_calls, rank_sort_calls=sort_calls,
                  vector_checks={p: {"max_score_err": e, "queries_ids_differ": d}
                                 for p, (e, d) in vec_stats.items()})

    # -- phase 4b: the mesh plane, eight shards on the card ------------------------
    report["mesh"], mesh_launches, mesh_cap = mesh_phase(dev, tables, ticks, oracles, walls,
                                                         counters)

    # -- phase 5: where the time goes ----------------------------------------------
    # a warm run of each path with the engine's host steps timed: the read +
    # bridge of every input batch, the rest of the input tasks (K1, the
    # partition split K4, the batch cache), and each executor kind's tasks
    # (joins, aggregates, top-k, the result's copy to the host)
    Engine = engine_mod.Engine
    real = (Engine._read_and_bridge, Engine.handle_input_task, Engine.handle_exec_task)
    host_steps = {}
    for path, (stream, *_) in paths.items():
        set_strategy(path)
        spent = {}

        def add(what, t):
            spent[what] = spent.get(what, 0.0) + time.perf_counter() - t

        def read_and_bridge(self, *a):
            t = time.perf_counter()
            try:
                return real[0](self, *a)
            finally:
                add("read+bridge", t)

        def input_task(self, task):
            t = time.perf_counter()
            try:
                return real[1](self, task)
            finally:
                add("input tasks", t)

        def exec_task(self, task):
            t = time.perf_counter()
            try:
                return real[2](self, task)
            finally:
                add("exec " + type(self.execs[(task.actor, task.channel)]).__name__, t)

        Engine._read_and_bridge, Engine.handle_input_task, Engine.handle_exec_task = (
            read_and_bridge, input_task, exec_task)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collect_numpy(stream(), path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            Engine._read_and_bridge, Engine.handle_input_task, Engine.handle_exec_task = real
        spent["input tasks"] -= spent["read+bridge"]
        spent["rest (plan, lowering, engine loop)"] = wall - sum(spent.values())
        host_steps[path] = {"wall_s": wall, **spent}
        print(f"where ({path} timed warm run, host seconds): wall {wall:.4f}; " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(spent.items(), key=lambda kv: -kv[1])))
    set_strategy()
    report["host_steps"] = host_steps
    q1_reader = TableReader(li)
    q1_reader.columns = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                         "l_returnflag", "l_linestatus", "l_shipdate"]
    state = q1_reader.get_own_state(1)[0]
    q1_cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
               "l_linestatus", "l_shipdate"]
    t0 = time.perf_counter()
    host = [q1_reader.execute(0, lin).select(q1_cols) for lin in state]
    report["q1_read_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for table in host:
        bridge.host_to_device(table, dev)
    torch.cuda.synchronize()
    report["q1_encode_and_h2d_s"] = time.perf_counter() - t0
    del host
    print(f"where (q1 outside a query): reader alone {report['q1_read_s']:.4f} s, bridge "
          f"(pad, sentinels, pinned staging, H2D) alone {report['q1_encode_and_h2d_s']:.4f} s")

    prefixes = ("qk_predicate", "qk_bucket_", "qk_small_pre", "qk_pre_agg",
                "qk_insert_kernel", "qk_gb_", "qk_partition_kernel",
                "qk_probe_kernel", "qk_sorted_probe_kernel", "qk_mm_expand_kernel",
                "qk_elemwise", "qk_asof_probe", "qk_fill_", "qk_bounds_chain", "qk_window_",
                "qk_range_", "qk_sims_", "qk_topk_merge_kernel", "qk_gram_",
                "qk_plan_", "qk_adapt_kernel", "qk_decode", "qk_mesh_", "qk_pk_", "qk_concat",
                "qk_rank_kernel", "qk_mm_fill_kernel", "qk_sort_")
    profiles = {}
    for path, (stream, *_) in paths.items():
        set_strategy(path)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            collect_numpy(stream(), path)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = device_events(prof)
        busy = sum(t for t, _ in ev.values()) / 1e6
        per_kernel = {}
        for prefix in prefixes:
            hits = [(t, c) for k, (t, c) in ev.items() if k.startswith(prefix)]
            if hits:
                t, c = sum(h[0] for h in hits), sum(h[1] for h in hits)
                per_kernel[prefix] = {"us_total": t, "launches": c, "us_per_launch": t / c}
        med = sorted(walls[path]["warm_s"])[len(walls[path]["warm_s"]) // 2]
        _, d2h, stream_syncs = profile_counts(prof)
        profiles[path] = {"wall_s": wall, "device_busy_s": busy, "warm_median_s": med,
                          "idle_share_of_warm": None if busy == 0 else 1 - busy / med,
                          "kernels_device_us": per_kernel, "d2h": d2h, "syncs": stream_syncs,
                          "top": sorted(ev.items(), key=lambda kv: -kv[1][0])[:15]}
        print(f"where ({path}): profiled run {wall:.3f} s wall, device busy {busy:.4f} s, "
              f"idle share of the warm median {med:.3f} s: "
              f"{'not measured' if busy == 0 else round(1 - busy / med, 4)}; {d2h} D2H "
              f"copies, {stream_syncs} cudaStreamSynchronize")
        if path in ("q4", "q21"):
            print(f"where ({path}) device time by operation (us, calls): "
                  + "; ".join(f"{k[:60]} {t:.0f} ({c})" for k, (t, c) in profiles[path]["top"][:8]))
    set_strategy()
    report["profiles"] = profiles

    # -- phase 5b: Q1, Q3, Q5 beside the parent's tree, in turns ------------------
    if args.parent:
        runs = []
        for label, pkg in (("parent", args.parent), ("change", str(ROOT)),
                           ("change", str(ROOT)), ("parent", args.parent)):
            r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--walls-only",
                                "--package", pkg, "--sf", str(args.sf), "--seed",
                                str(args.seed)], capture_output=True, text=True, timeout=600)
            lines = [l for l in r.stdout.splitlines() if l.startswith('{"walls"')]
            if r.returncode or not lines:
                fail(f"walls-only run of {pkg} failed ({r.returncode}): {r.stderr[-2000:]}")
            runs.append((label, json.loads(lines[-1])["walls"]))
        report["parent_compare"] = runs
        for q in COMPARED:
            for label, w in runs:
                v = w[q]
                print(f"compare {q} {label}: warm {[round(x, 4) for x in v['warm_s']]} s, "
                      f"read+bridge {v['read_bridge_s']:.4f} s of a {v['timed_wall_s']:.4f} s "
                      f"run, idle share {v['idle_share_of_warm']:.4f}, {v['d2h']} D2H copies, "
                      f"{v['syncs']} cudaStreamSynchronize, {v['ledger_count_reads']} ledger "
                      "count reads")
            parent = {(w[q]["d2h"], w[q]["syncs"]) for label, w in runs if label == "parent"}
            change = {(w[q]["d2h"] - w[q]["ledger_count_reads"],
                       w[q]["syncs"] - w[q]["ledger_count_reads"])
                      for label, w in runs if label == "change"}
            if len(parent) != 1 or change != parent:
                fail(f"{q}: D2H copies and stream syncs (less the ledger's count reads) "
                     f"{sorted(change)} differ from the parent's {sorted(parent)}")

    # -- phase 5c: the calibrated peaks (row 25) and EXPLAIN ANALYZE ------------------
    prof25 = devprof.ensure_calibrated()
    report["calibration"] = prof25
    print(f"devprof calibration on {prof25['device']}: peak_flops_s "
          f"{prof25['peak_flops_s']:.6g} (data sheet {FP32_FLOP_PER_S:.6g} float32), "
          f"peak_bw_bytes_s {prof25['peak_bw_bytes_s']:.6g} (data sheet "
          f"{HBM_BYTES_PER_S:.6g}); {MATMUL_N_NOTE}; allow_tf32 "
          f"{prof25['matmul_allow_tf32']}; timings {prof25['timings_s']}")
    explained = {}
    for q in ("q1", "q5"):
        collect_numpy(tpch_stream(q, ctx, tables), q)
        text = explain.render(obs.OPSTATS.last_finished())
        if "device efficiency (peaks:" not in text or "EXPLAIN ANALYZE" not in text:
            fail(f"{q}: EXPLAIN ANALYZE has no calibrated efficiency section:\n{text}")
        explained[q] = text
        print(f"EXPLAIN ANALYZE of {q}:\n{text}")
    report["explain_analyze"] = explained

    # the calls the Q3 paths make: counts per query and the largest arguments
    def rows_of(*a, **kw):
        for x in list(a) + list(kw.values()):
            if isinstance(x, torch.Tensor):
                return x.shape[0]
            if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
                return x[0].shape[0]
            if hasattr(x, "padded_len"):
                return x.padded_len
            if isinstance(x, (list, tuple)) and x and hasattr(x[0], "padded_len"):
                return sum(b.padded_len for b in x)
        return 0

    def gather_rows(cols, idx):
        return idx.shape[0]

    def targets(sorted_path):
        t = {"K3": (hashtable, "hash_groupby", lambda l, a, o, v: v.shape[0]),
             "K4": (kernels, "partition_split", lambda l, p, v, n, masks=True: v.shape[0]),
             "K5": (fuse.PreAggCall, "__init__", lambda self, *a: a[4].shape[0]),
             "row 7 gather": (join, "gather_columns", gather_rows),
             "K8": (bridge, "compact_concat",
                    lambda b, pc, d, t, pad: sum(x.padded_len for x in b)),
             "row 14 count": (join, "_count_true", rows_of),
             "row 15 sort": (kernels, "lexsort_perm", rows_of)}
        if sorted_path:
            t["K12"] = (join, "pk_probe_sorted", lambda s, pm, nv, pl, ok: ok.shape[0])
            t["row 14 dup"] = (join, "_sorted_has_dup", rows_of)
        else:
            # the orders join: the largest probe against the largest table
            t["K11"] = (hashtable, "probe", lambda tb, bl, pl, ok, cb: ok.shape[0] * 64 + cb)
            t["K11 build"] = (hashtable, "_build_insert", lambda l, ok, cb: ok.shape[0])
            t["row 14 distinct"] = (join, "_distinct_from_table", rows_of)
        return t

    caps = {}
    for path in ("q3", "q3 sort"):
        set_strategy(path)
        with Capture(targets(path == "q3 sort"), keep_every=["K11 build"]) as cap:
            collect_numpy(q3_stream(), path)
        caps[path] = cap
        print(f"{path} calls per query: {cap.calls}")
    set_strategy()
    report["q3_calls"] = {p: c.calls for p, c in caps.items()}
    hcap, scap = caps["q3"], caps["q3 sort"]

    # the calls the slice-3 paths make: Q13's expands and plans, Q4's and
    # Q21's semi / anti plans (K13p without build positions, each with its
    # K10 pass), Q7's in-stage elementwise calls (K16)
    s3 = {}
    counts_target = {"K13p counts": (join, "_mm_counts", lambda l, v, p: v.shape[0])}
    for path, stream, tg in (
            ("q13", q13_stream, {"K13": (join, "mm_expand", lambda *a: a[5]),
                                 "K13p": (join, "_mm_plan", lambda l, v, p: v.shape[0])}),
            ("q4", q4_stream, dict(counts_target)),
            ("q21", q21_stream, dict(counts_target)),
            ("q7", q7_stream, {"K16": (stagefuse.ElemwiseCall, "__init__",
                                       lambda self, *a: a[5].shape[0]),
                               "K4": (kernels, "partition_split",
                                      lambda l, p, v, n, masks=True: v.shape[0])})):
        with Capture(tg) as cap:
            collect_numpy(stream(), path)
        s3[path] = cap
        print(f"{path} calls per query: {cap.calls}")
    report["slice3_calls"] = {p: c.calls for p, c in s3.items()}

    # the calls the time-series paths make: the largest of each kernel's
    ts_targets = {
        "asof": {"K18": (asof, "asof_probe",
                         lambda so, pm, nv, po, pv, up, nk, runs=None: pv.shape[0])},
        "asof forward": {"K18": (asof, "asof_probe",
                                 lambda so, pm, nv, po, pv, up, nk, runs=None: pv.shape[0]),
                         "K2": (fuse.FusedPartialAgg, "prepare_small",
                                lambda self, b: b.padded_len)},
        "asof sort": {"K19": (asof, "seg_fill_forward", lambda v, st: v.shape[0])},
        "sliding": {"K19 bounds": (asof, "segment_bounds", lambda fl: fl.shape[0]),
                    "K20a": (ts_execs, "window_bounds", lambda t, a, b, sz: t.shape[0]),
                    "K20b": (ts_execs, "range_minmax", lambda x, lf, rt, op: x.shape[0]),
                    "row 9 reduce": (kernels, "reduce_array", lambda a, v, op: a.shape[0]),
                    # the optimizer's catalog masks its samples on the CPU
                    "mask": (kernels, "apply_mask",
                             lambda b, m: m.shape[0] if m.is_cuda else -1)},
        "shift": {"K19 bounds": (asof, "segment_bounds", lambda fl: fl.shape[0])},
        **{p: {"K3": (hashtable, "hash_groupby", lambda l, a, o, v: v.shape[0])}
           for p in ("tumbling", "hopping")}}
    s4 = {}
    for path, tg in ts_targets.items():
        set_strategy(path)
        with Capture(tg, keep_every=["K20b"] if path == "sliding" else ()) as cap:
            collect_numpy(paths[path][0](), path)
        s4[path] = cap
        print(f"{path} calls per query: {cap.calls}")
    set_strategy()
    report["slice4_calls"] = {p: c.calls for p, c in s4.items()}

    # the calls the vector tier makes: the largest K21 and K22 calls
    s5 = {}
    for path, tg in (
            ("vector", {"K21": (vops, "sims_topk",
                                lambda q, v, va, k, ss, sh, b: q.shape[0] * v.shape[0])}),
            ("gramian", {"K22": (lops, "gramian", lambda cols, va: va.shape[0])})):
        with Capture(tg) as cap:
            collect_numpy(paths[path][0](), path)
        s5[path] = cap
        print(f"{path} calls per query: {cap.calls}")
    report["slice5_calls"] = {p: c.calls for p, c in s5.items()}

    # the calls the slice-6 paths make: K17's largest plan on Q3 compacted,
    # K26's largest split on the skew join, K6's largest call on Q1 sort
    s6 = {}
    for path, tg in (
            ("q3 compacted", {"K17": (kernels, "partition_plan", lambda p, v, n: v.shape[0])}),
            ("skewjoin", {"K26": (kernels, "adapt_split",
                                  lambda l, p, v, n, f, m, masks=True:
                                  (l[0] if l else p).shape[0])}),
            ("q1 sort", {"K6": (fuse, "onehot_agg", lambda fc, ic, co, st, g, v: v.shape[0])})):
        set_strategy(path)
        with Capture(tg) as cap:
            collect_numpy(paths[path][0](), path)
        s6[path] = cap
        print(f"{path} calls per query: {cap.calls}")
    set_strategy()
    report["slice6_calls"] = {p: c.calls for p, c in s6.items()}

    # -- phase 6: every kernel against its plain version -----------------------------
    out, t_rows = [], []
    first = bridge.host_to_device(q1_reader.execute(0, state[0]).select(q1_cols), dev)
    n = first.padded_len

    # K1 at Q1's shape
    pred = fuse.FusedPredicate(sqlparse.parse_expression(Q1_FILTER))
    e, kern, inputs = pred.prepare(first)
    ins = list(inputs.values())
    m_k, c_k = fuse.predicate_launch(kern, ins, first.valid)
    m_p, c_p = fuse.predicate_plain(e, inputs, first.valid)
    if not (torch.equal(m_k, m_p) and int(c_k) == int(c_p)):
        fail("K1 mask/count differ from the plain version")
    out.append(dict(
        name="K1 fused predicate", route="triton", source="quokka_tpu_torch/ops/fuse.py",
        replaces="quokka_tpu/ops/fuse.py:567", launches=launches_by_path["q1"]["K1"],
        max_abs_err=0.0, ms=cuda_ms(lambda: fuse.predicate_launch(kern, ins, first.valid)),
        plain_ms=cuda_ms(lambda: fuse.predicate_plain(e, inputs, first.valid)),
        bound_ms=bound_ms(nbytes(*ins, first.valid) + n + 4), bound_by="bytes",
        library_ms=None, shape=f"{n} rows",
        device_us=device_us(lambda: fuse.predicate_launch(kern, ins, first.valid),
                            ("qk_predicate",), expect=("qk_predicate",))))
    filtered = pred(first)

    # K2 at Q1's shape and at the forward as-of's largest call (the tick
    # shape): the whole call (pre-pass and bucket core) against its plain
    # version and again for the same bits; the pre-pass alone against K5's
    # plain evaluator; the yardstick one index_add_ of the stacked float64
    # inputs by bucket (sums only, not the same function)
    plan = plan_aggregation(sqlparse.parse_select_list(Q1_AGGS))
    keys = ["l_returnflag", "l_linestatus"]
    pagg = fuse.FusedPartialAgg(keys, plan)
    call = pagg.prepare_small(filtered)
    if call is None:
        fail("Q1 batch did not take the small-key path")
    tick_agg, tick_batch = s4["asof forward"].args["K2"][0]
    tick_call = tick_agg.prepare_small(tick_batch)
    if tick_call.kern.pre is not None:
        fail(f"the as-of K2 plan {tick_call.kern.pre_outs} is not plain columns and count(*)")

    def check_k2(label, c) -> float:
        (sk, rk), (sp, rp) = c.launch(), c.plain()
        again = c.launch()
        torch.cuda.synchronize()
        if not torch.equal(rk, rp):
            fail(f"K2 {label}: min row ids differ from the plain version")
        err = 0.0
        for a, b in zip(sk, sp):
            if a.dtype != b.dtype:
                fail(f"K2 {label}: {a.dtype} outputs, the plain version's {b.dtype}")
            if a.is_floating_point():
                if not torch.allclose(a, b, rtol=1e-9, atol=0):
                    fail(f"K2 {label}: sums beyond rtol 1e-9 of the plain version")
                err = max(err, float((a - b).abs().max()))
            elif not torch.equal(a, b):
                fail(f"K2 {label}: counts or integer sums differ from the plain version")
        if not all(torch.equal(a.view(torch.int64) if a.is_floating_point() else a,
                               b.view(torch.int64) if b.is_floating_point() else b)
                   for a, b in zip(sk + [rk], again[0] + [again[1]])):
            fail(f"K2 {label}: two launches gave other bits")
        print(f"K2 {label}: {c.valid.shape[0]} rows, {c.n_groups + 1} buckets, core columns "
              f"{[src for src, _ in c.kern.cols]}: matches the plain version (max abs err {err}), "
              "the same bits in two launches")
        return err

    def k2_row(c):
        sums, rep2 = c.plain()
        k2_in = list(c.inputs.values()) + c.codes + [c.valid]
        # the yardstick's operands, built outside the timing
        gid2 = fuse._bucket_ids(c.codes, c.strides, c.valid, c.n_groups)
        cols = [c.inputs[src[1]] for src, t in c.kern.cols
                if src[0] == "col" and fuse._float_tag(t)]
        if c.kern.pre is not None:
            pre = fuse.pre_exprs_plain(c.pre_exprs, c.kern.pre_outs, c.inputs, c.valid)
            cols += [x.to(torch.float64) for x in pre if x.is_floating_point()]
        stacked = torch.stack([x.to(torch.float64) for x in cols], 1)
        acc = torch.zeros((c.n_groups + 1, stacked.shape[1]), dtype=torch.float64, device=dev)
        return dict(
            ms=cuda_ms(c.launch), plain_ms=cuda_ms(c.plain),
            bound_ms=bound_ms(nbytes(*k2_in) + sum(nbytes(x) for x in sums) + nbytes(rep2)),
            library_ms=cuda_ms(lambda: acc.index_add_(0, gid2, stacked)),
            device_us=device_us(c.launch, ("qk_bucket_", "qk_small_pre"),
                                expect=("qk_bucket_agg", "qk_bucket_reduce")),
            shape=f"{c.valid.shape[0]} rows, {c.n_groups + 1} buckets, inputs "
                  f"{ {k: str(t.dtype) for k, t in c.inputs.items()} }, pre-pass outputs "
                  f"{c.kern.pre_outs}")

    err2 = max(check_k2("Q1", call), check_k2("asof forward", tick_call))
    q1_row, tick_row = k2_row(call), k2_row(tick_call)
    out.append(dict(
        name="K2 small-key partial aggregate", route="cuda",
        source="quokka_tpu_torch/csrc/onehot.cu", replaces="quokka_tpu/ops/fuse.py:462",
        launches=launches_by_path["q1"]["K2"], max_abs_err=err2, bound_by="bytes",
        library="one index_add_ of the stacked float64 inputs by bucket: sums only, not the "
                "same function",
        **q1_row, per_query={p: launches_by_path[p]["K2"] for p in paths
                             if launches_by_path[p]["K2"]},
        tick={"launches": launches_by_path["asof forward"]["K2"], **tick_row}))

    # K2's pre-pass alone at Q1's shape, against K5's plain evaluator
    pre_in = [call.inputs[k] for k in call.kern.pre_inputs]
    got_pre = fuse._pre_launch(call.kern.pre, pre_in, call.valid, call.kern.pre_dtypes)
    want_pre = fuse.pre_exprs_plain(call.pre_exprs, call.kern.pre_outs, call.inputs, call.valid)
    err_pre = 0.0
    for a, b in zip(got_pre, want_pre):
        b = b.to(a.dtype)
        if not torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True):
            fail("K2's pre-pass differs from the plain evaluator beyond rtol 1e-12")
        fin = ~torch.isnan(b) if b.is_floating_point() else torch.ones_like(b, dtype=torch.bool)
        err_pre = max(err_pre, float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0)
    out.append(dict(
        name="K2 pre-pass (expression inputs)", route="triton",
        source="quokka_tpu_torch/ops/fuse.py", replaces="quokka_tpu/ops/fuse.py:462",
        launches=launches_by_path["q1"]["K2 pre"], max_abs_err=err_pre,
        ms=cuda_ms(lambda: fuse._pre_launch(call.kern.pre, pre_in, call.valid,
                                             call.kern.pre_dtypes)),
        plain_ms=cuda_ms(lambda: fuse.pre_exprs_plain(call.pre_exprs, call.kern.pre_outs,
                                                      call.inputs, call.valid)),
        bound_ms=bound_ms(nbytes(*pre_in, call.valid) + sum(nbytes(x) for x in got_pre)),
        bound_by="bytes", library_ms=None, shape=f"{n} rows, outputs {call.kern.pre_outs}",
        device_us=device_us(lambda: fuse._pre_launch(call.kern.pre, pre_in, call.valid,
                                                     call.kern.pre_dtypes), ("qk_small_pre",),
                            expect=("qk_small_pre",)),
        per_query={p: launches_by_path[p]["K2 pre"] for p in paths
                   if launches_by_path[p]["K2 pre"]}))

    # K3: a Q1 recombine of a few partial batches, Q3's largest call and the
    # largest calls of tumbling and hopping; each K3 call under the sync
    # debug mode, which raises on a host read
    def key_order(k):
        idx = torch.arange(k.shape[0], device=dev)
        for c in reversed(range(k.shape[1])):
            idx = idx[torch.argsort(k[idx, c], stable=True)]
        return idx

    def no_sync(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def check_k3(label, lb, ar, op, va) -> float:
        ko, kc, kr, kn = no_sync(lambda: hashtable.hash_groupby(lb, ar, op, va))
        plain = hashtable.hash_groupby_plain(lb, ar, op, va)
        if plain is None:
            fail(f"K3 {label}: the plain version's insert did not converge")
        po, pc, pr, pn = plain
        if int(kn) != int(pn):
            fail(f"K3 {label}: {int(kn)} groups vs {int(pn)} in the plain version")
        g_n = int(kn)
        # compare after a sort on the keys (group order is claim order)
        kk = torch.stack([l[kr[:g_n].long()].to(torch.float64) for l in lb], 1)
        pk = torch.stack([l[pr[:g_n].long()].to(torch.float64) for l in lb], 1)
        ko_i, po_i = key_order(kk), key_order(pk)
        if not torch.equal(kk[ko_i], pk[po_i]):
            fail(f"K3 {label}: group keys differ from the plain version")
        if not torch.equal(kc[:g_n][ko_i], pc[:g_n][po_i]):
            fail(f"K3 {label}: counts differ")
        err = 0.0
        for name, a, b in zip(op, ko, po):
            a, b = a[:g_n][ko_i], b[:g_n][po_i]
            if a.is_floating_point():
                if not torch.allclose(a, b, rtol=1e-9, atol=1e-12, equal_nan=True):
                    fail(f"K3 {label}: {name} beyond rtol 1e-9")
                both = ~(torch.isnan(a) | torch.isnan(b))
                if both.any():
                    err = max(err, float((a[both] - b[both]).abs().max()))
            elif not torch.equal(a, b):
                fail(f"K3 {label}: {name} differs")
        print(f"K3 {label}: {g_n} groups match the plain version, no host read in the call")
        return err

    def k3_bytes(lb, ar, op, va):
        """What the group-by must move: every row's validity byte, the keys
        and inputs of the live rows, and the outputs it writes (counts, the
        smallest rows, the group count, one array per aggregate; an integer
        count is the counts array itself)."""
        m, live = va.shape[0], int(va.sum())
        ko, kc, _, _ = hashtable.hash_groupby(lb, ar, op, va)
        outs = sum(nbytes(o) for o in ko if o.data_ptr() != kc.data_ptr())
        return (m + live * sum(t.element_size() for t in (*lb, *ar)) + m * (4 + 4) + 4 + outs)

    pex = PartialAggExecutor(keys, plan)
    parts = [kernels.compact(pex._partial(pred(bridge.host_to_device(
        q1_reader.execute(0, lin).select(q1_cols), dev)))) for lin in state[:3]]
    merged = bridge.concat_batches(parts)
    limbs = key_limbs(merged, keys)
    arrays = [merged.columns[p].data for p, _ in plan.recombine]
    ops = [op for _, op in plan.recombine]
    k3_calls = {"q1": (limbs, arrays, ops, merged.valid), "q3": hcap.args["K3"][0],
                "tumbling": s4["tumbling"].args["K3"][0],
                "hopping": s4["hopping"].args["K3"][0]}
    k3_label = {"q1": "Q1 recombine", "q3": "Q3 largest call",
                "tumbling": "tumbling's largest call", "hopping": "hopping's largest call"}
    k3_err = max(check_k3(k3_label[p], *a) for p, a in k3_calls.items())

    def k3_row(p):
        lb, ar, op, va = k3_calls[p]
        fn = lambda: hashtable.hash_groupby(lb, ar, op, va)  # noqa: E731
        no_sync(fn)
        return {"shape": f"{va.shape[0]} rows ({int(va.sum())} live), {len(lb)} key columns, "
                         f"{len(ar)} aggregates",
                "launches": launches_by_path[p]["K3"],
                "ms": cuda_ms(fn, iters=20 if p == "q1" else 5),
                "plain_ms": cuda_ms(lambda: hashtable.hash_groupby_plain(lb, ar, op, va),
                                    iters=5 if p == "q1" else 2, warmup=1),
                # the whole call: memset and every kernel
                "device_us": device_us(fn, iters=10 if p == "q1" else 5, expect=K3_OPS),
                "bound_ms": bound_ms(k3_bytes(lb, ar, op, va))}

    k3 = {p: k3_row(p) for p in k3_calls}
    out.append(dict(
        name="K3 hash group-by", route="cuda", source="quokka_tpu_torch/csrc/hashtable.cu",
        replaces="quokka_tpu/ops/hashtable.py:310", max_abs_err=k3_err, bound_by="bytes",
        library_ms=None, **k3["q1"], q3=k3["q3"], tumbling=k3["tumbling"],
        hopping=k3["hopping"], per_query={p: launches_by_path[p]["K3"] for p in paths}))

    def k4_largest(cap, launches):
        """K4 at a path's largest captured split, as the path called it."""
        (l7, p7, v7, n7, *m7), kw7 = cap.args["K4"]
        masks7 = kw7.get("masks", m7[0] if m7 else True)
        want7 = kernels.partition_split_plain(l7, p7, v7, n7, masks7)
        if not all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(kernels.partition_split(l7, p7, v7, n7, masks7), want7)):
            fail("K4 at Q7's largest split differs from the plain version")

        def call():
            return kernels.partition_split(l7, p7, v7, n7, masks7)

        n = v7.shape[0]
        return {"shape": f"{n} rows, {len(l7)} limbs, {n7} parts, masks {masks7}",
                "launches": launches, "ms": cuda_ms(call),
                "plain_ms": cuda_ms(lambda: kernels.partition_split_plain(l7, p7, v7, n7, masks7)),
                "device_us": device_us(call, ("qk_partition_kernel",)),
                "bound_ms": bound_ms(nbytes(*l7, *[t for t in (p7, v7) if t is not None])
                                     + n * (4 if l7 else 0)
                                     + (n * n7 + 4 * n7 if masks7 else 0))}

    # K4: Q1's exchange of the partial state, Q3's and Q7's largest splits
    state_b = kernels.compact(pex._recombine(parts))
    (q3_l4, q3_p4, q3_v4, q3_n4), _ = hcap.args["K4"]
    for label, lb, va in (("Q1 exchange", key_limbs(state_b, keys), state_b.valid),
                          ("Q3 largest split", q3_l4, q3_v4)):
        for n_parts in (2, 7):  # 7: an id mod 2 hides a differing hash bit 31
            a = kernels.partition_split(lb, None, va, n_parts)
            b = kernels.partition_split_plain(lb, None, va, n_parts)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"K4 {label}, {n_parts} parts: ids/masks/counts differ from the plain version")
        print(f"K4 {label}: ids, masks and counts match the plain version (2 and 7 parts)")
    lb4, va4 = key_limbs(state_b, keys), state_b.valid
    out.append(dict(
        name="K4 hash partition + split", route="cuda",
        source="quokka_tpu_torch/csrc/partition.cu", replaces="quokka_tpu/ops/kernels.py:386",
        launches=launches_by_path["q1"]["K4"], max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.partition_split(lb4, None, va4, 2)),
        plain_ms=cuda_ms(lambda: kernels.partition_split_plain(lb4, None, va4, 2)),
        bound_ms=bound_ms(nbytes(*lb4, va4) + va4.shape[0] * (4 + 2) + 8),
        bound_by="bytes", library_ms=None,
        shape=f"{va4.shape[0]} rows, {len(lb4)} limbs, 2 parts",
        device_us=device_us(lambda: kernels.partition_split(lb4, None, va4, 2),
                            ("qk_partition_kernel",)),
        q3={"shape": f"{q3_v4.shape[0]} rows, {len(q3_l4)} limbs, {q3_n4} parts",
            "launches": launches_by_path["q3"]["K4"],
            "ms": cuda_ms(lambda: kernels.partition_split(q3_l4, None, q3_v4, q3_n4)),
            "plain_ms": cuda_ms(lambda: kernels.partition_split_plain(q3_l4, None, q3_v4,
                                                                      q3_n4)),
            "device_us": device_us(lambda: kernels.partition_split(q3_l4, None, q3_v4, q3_n4),
                                   ("qk_partition_kernel",)),
            "bound_ms": bound_ms(nbytes(*q3_l4, q3_v4) + q3_v4.shape[0] * (4 + q3_n4)
                                 + 4 * q3_n4)},
        q7=k4_largest(s3["q7"], launches_by_path["q7"]["K4"])))

    # K5 at Q3's shape: the pre-expression of the partial aggregate
    (k5_call, *_), _ = hcap.args["K5"]
    k5_k, k5_p = k5_call.launch(), k5_call.plain()
    err5 = 0.0
    for a, b in zip(k5_k, k5_p):
        if a.dtype != b.dtype:
            fail(f"K5 output dtype {a.dtype} != the plain version's {b.dtype}")
        if a.is_floating_point():
            if not torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True):
                fail("K5 values beyond rtol 1e-12 of the plain version")
            both = ~(torch.isnan(a) | torch.isnan(b))
            err5 = max(err5, float((a[both] - b[both]).abs().max()))
        elif not torch.equal(a, b):
            fail("K5 values differ from the plain version")
    print(f"K5 Q3: {len(k5_k)} pre-expression column(s) over {k5_call.valid.shape[0]} rows "
          f"match the plain version (max abs err {err5})")
    k5_in = list(k5_call.inputs.values()) + [k5_call.valid]
    out.append(dict(
        name="K5 general partial aggregate (pre-expressions)", route="triton",
        source="quokka_tpu_torch/ops/fuse.py", replaces="quokka_tpu/ops/fuse.py:319",
        launches=launches_by_path["q3"]["K5"], max_abs_err=err5, ms=cuda_ms(k5_call.launch),
        plain_ms=cuda_ms(k5_call.plain), bound_ms=bound_ms(nbytes(*k5_in, *k5_k)),
        bound_by="bytes", library_ms=None,
        shape=f"{k5_call.valid.shape[0]} rows, {len(k5_in) - 1} input columns",
        device_us=device_us(k5_call.launch, ("qk_pre_agg",))))

    # K11 at Q3's shapes: the lineitem probe of the orders build, and that
    # build's insert.  The kernel probe walks the table the query's kernel
    # built; the plain probe walks a table the plain insert builds from the
    # same rows: both give the same (build_idx, matched).
    (tbl, bl, pl, pok, cb), _ = hcap.args["K11"]
    builds = [a for a, _ in hcap.every["K11 build"] if a[0][0] is bl[0]]
    if not builds:
        fail("K11: the probed table's build call was not captured")
    b_limbs, b_ok, b_cap = builds[0]
    _, t_plain, conv_p = hashtable._insert_plain(b_limbs, b_ok, b_cap)
    t_kernel, conv_k = hashtable._build_insert(b_limbs, b_ok, b_cap)
    if not (conv_k and conv_p):
        fail("K11 build did not converge at Q3's shape")
    ik, mk = hashtable._probe_cuda(tbl, bl, pl, pok, cb)
    ip, mp = hashtable._probe_plain(t_plain, bl, pl, pok, cb)
    ik2, mk2 = hashtable._probe_cuda(t_kernel, bl, pl, pok, cb)
    if not (torch.equal(mk, mp) and torch.equal(ik[mk], ip[mp])
            and torch.equal(mk2, mp) and torch.equal(ik2[mk2], ip[mp])):
        fail("K11 probe differs from the plain version at Q3's shape")
    n_ok, n_match = int(pok.sum()), int(mk.sum())
    print(f"K11 Q3: build {b_ok.shape[0]} rows ({int(b_ok.sum())} keys), probe "
          f"{pok.shape[0]} rows ({n_ok} probing, {n_match} matched) match the plain version")
    nl = len(pl)
    out.append(dict(
        name="K11 hash PK probe", route="cuda", source="quokka_tpu_torch/csrc/hashtable.cu",
        replaces="quokka_tpu/ops/hashtable.py:236", launches=launches_by_path["q3"]["K11"],
        max_abs_err=0.0, ms=cuda_ms(lambda: hashtable._probe_cuda(tbl, bl, pl, pok, cb)),
        plain_ms=cuda_ms(lambda: hashtable._probe_plain(t_plain, bl, pl, pok, cb), iters=3,
                         warmup=1),
        bound_ms=bound_ms(pok.shape[0] * (4 * nl + 1 + 5) + n_ok * 4 + n_match * 4 * nl),
        bound_by="bytes", library_ms=None,
        shape=f"probe {pok.shape[0]} rows x {nl} limbs, table 2^{cb}",
        device_us=device_us(lambda: hashtable._probe_cuda(tbl, bl, pl, pok, cb),
                            ("qk_probe_kernel",)),
        build={"launches": launches_by_path["q3"]["K11 build"],
               "shape": f"{b_ok.shape[0]} rows x {len(b_limbs)} limbs, table 2^{b_cap}",
               "ms": cuda_ms(lambda: hashtable._build_insert(b_limbs, b_ok, b_cap)),
               "plain_ms": cuda_ms(lambda: hashtable._insert_plain(b_limbs, b_ok, b_cap),
                                   iters=3, warmup=1),
               "device_us": device_us(lambda: hashtable._build_insert(b_limbs, b_ok, b_cap),
                                      ("qk_insert_kernel",)),
               "bound_ms": bound_ms(nbytes(*b_limbs, b_ok) + 4 * (1 << b_cap)
                                    + int(b_ok.sum()) * 4)}))

    # K12 at Q3's shape (the sort path's orders probe), and on float64 keys
    (s_limbs, s_perm, s_nv, s_pl, s_ok), _ = scap.args["K12"]
    ik, mk = join._pk_probe_sorted_cuda(s_limbs, s_perm, s_nv, s_pl, s_ok)
    ip, mp = join._pk_probe_sorted_plain(s_limbs, s_perm, s_nv, s_pl, s_ok)
    if not (torch.equal(mk, mp) and torch.equal(ik[mk], ip[mp])):
        fail("K12 differs from the plain version at Q3's shape")
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    fb = (torch.randperm(1 << 21, generator=g)[:1 << 19].to(torch.float64) - (1 << 20)) / 8
    fb[torch.rand(1 << 19, generator=g) < 0.02] = float("nan")
    fb[fb == 0] = 0.0625  # multiples of 1/8 only: 0.0625 is never a build key
    fb[0] = -0.0
    fprobe = fb[torch.randint(0, 1 << 19, (1 << 22,), generator=g)]
    fprobe[torch.rand(1 << 22, generator=g) < 0.3] += 0.0625  # unmatched
    fprobe[:1000] = 0.0  # +0.0 must meet the build's -0.0
    fvalid = torch.rand(1 << 19, generator=g) < 0.95
    f_sorted, f_perm, f_nv = join._sort_build_keys([fb.to(dev)], fvalid.to(dev))
    f_ok = torch.ones(1 << 22, dtype=torch.bool, device=dev)
    fk = join._pk_probe_sorted_cuda(f_sorted, f_perm, f_nv, [fprobe.to(dev)], f_ok)
    fp = join._pk_probe_sorted_plain(f_sorted, f_perm, f_nv, [fprobe.to(dev)], f_ok)
    if not (torch.equal(fk[1], fp[1]) and torch.equal(fk[0][fk[1]], fp[0][fp[1]])):
        fail("K12 differs from the plain version on float64 keys with -0.0 and NaN")
    zero_hits = int((fk[1] & (fprobe.to(dev) == 0)).sum())
    print(f"K12 Q3: probe {s_ok.shape[0]} rows over {s_perm.shape[0]} sorted build rows, and "
          f"float64 keys with -0.0/NaN ({int(fk[1].sum())} matched, {zero_hits} on +-0.0): "
          "match the plain version")
    nv = int(s_nv)
    s_valid0 = s_limbs[0][:nv].contiguous()
    lib_ms = (cuda_ms(lambda: torch.searchsorted(s_valid0, s_pl[0])) if len(s_limbs) == 1
              else None)
    lib_us = (device_us(lambda: torch.searchsorted(s_valid0, s_pl[0])) if len(s_limbs) == 1
              else None)
    steps = max(1, nv).bit_length() + 1
    n_sok = int(s_ok.sum())
    out.append(dict(
        name="K12 sorted PK probe", route="cuda", source="quokka_tpu_torch/csrc/join.cu",
        replaces="quokka_tpu/ops/join.py:84", launches=launches_by_path["q3 sort"]["K12"],
        max_abs_err=0.0,
        ms=cuda_ms(lambda: join._pk_probe_sorted_cuda(s_limbs, s_perm, s_nv, s_pl, s_ok)),
        plain_ms=cuda_ms(lambda: join._pk_probe_sorted_plain(s_limbs, s_perm, s_nv, s_pl,
                                                             s_ok), iters=5),
        bound_ms=bound_ms(nbytes(*s_pl, s_ok) + s_ok.shape[0] * 5
                          + min(nbytes(*s_limbs), n_sok * steps * sum(
                              l.element_size() for l in s_limbs)) + int(mk.sum()) * 4),
        bound_by="bytes", library_ms=lib_ms,
        shape=f"probe {s_ok.shape[0]} rows, sorted build {s_perm.shape[0]} rows x "
              f"{len(s_limbs)} limbs",
        device_us=device_us(lambda: join._pk_probe_sorted_cuda(s_limbs, s_perm, s_nv, s_pl,
                                                               s_ok),
                            ("qk_sorted_probe_kernel",)),
        library_device_us=lib_us))

    # K13 at Q13's shape (its largest expand), and with one probe key that
    # matches 10^4 build rows
    def check_k13(label, a):
        cum = torch.cumsum(a[0], 0)
        k = join._mm_expand_cuda(cum, *a[1:])
        q = join._mm_expand_plain(cum, *a[1:])
        for name, x, y in zip(("probe_idx", "build_idx", "out_valid", "unmatched"), k, q):
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                fail(f"K13 {label}: {name} differs from the plain version")
        print(f"K13 {label}: {a[5]} output rows ({int(a[4])} live) over {a[0].shape[0]} probe "
              f"rows match the plain version row for row")
        return cum

    def k13_bytes(a, cum):
        """Bytes K13 must move on this run's data: the cumsum, rank and
        unmatched flag of each probe row with an output row, the offset of
        each rank a matched probe row holds, the build positions of those
        ranks, the total, and every output row written once."""
        count, offsets, build_pos, rp, _, out_padded, unm = a
        live = count > 0
        matched = live if unm is None else live & ~unm
        ranks, inv = torch.unique(rp[matched], return_inverse=True)
        per_rank = torch.zeros(ranks.shape[0], dtype=count.dtype, device=count.device)
        per_rank.scatter_reduce_(0, inv, count[matched], "amax")
        flag = 0 if unm is None else 1
        return (int(live.sum()) * (cum.element_size() + rp.element_size() + flag)
                + ranks.shape[0] * offsets.element_size()
                + int(per_rank.sum()) * build_pos.element_size() + 8
                + out_padded * (4 + 4 + 1 + flag))

    (k13_a, _) = s3["q13"].args["K13"]
    k13_cum = check_k13("Q13", k13_a)
    g13 = torch.Generator(device="cpu").manual_seed(args.seed + 13)
    p_s, b_s = 1 << 16, 1 << 20
    bk = torch.randint(0, 1 << 19, (b_s,), generator=g13)
    pk = torch.randint(0, 1 << 19, (p_s,), generator=g13)
    bk[:10_000] = -1
    pk[:100] = -1
    s_limbs = [torch.cat([pk, bk]).to(dev)]
    s_valid = torch.ones(p_s + b_s, dtype=torch.bool, device=dev)
    sk = join.mm_plan_for(s_limbs, s_valid, p_s, "left", s_valid[:p_s])
    if int(sk[0][:100].min()) != 10_000:
        fail("K13 skewed case: the hot probe key does not match 10^4 build rows")
    sk_a = (sk[0], sk[2], sk[3], sk[4], sk[1], config.bucket_size(int(sk[1])), sk[5])
    sk_cum = check_k13("one key x 10^4 build rows", sk_a)

    def expand13(a, cum):
        return lambda: join._mm_expand_cuda(cum, *a[1:])

    def expand13_plain(a, cum):
        return lambda: join._mm_expand_plain(cum, *a[1:])

    out.append(dict(
        name="K13 many-to-many expand", route="cuda", source="quokka_tpu_torch/csrc/join.cu",
        replaces="quokka_tpu/ops/join.py:238", launches=launches_by_path["q13"]["K13"],
        max_abs_err=0.0, ms=cuda_ms(expand13(k13_a, k13_cum)),
        plain_ms=cuda_ms(expand13_plain(k13_a, k13_cum), iters=5),
        bound_ms=bound_ms(k13_bytes(k13_a, k13_cum)), bound_by="bytes", library_ms=None,
        shape=f"Q13: {k13_a[5]} output rows, {k13_a[0].shape[0]} probe rows, "
              f"{k13_a[2].shape[0]} build rows, left",
        device_us=device_us(expand13(k13_a, k13_cum), ("qk_mm_expand_kernel",)),
        skew={"shape": f"{sk_a[5]} output rows, {p_s} probe rows, {b_s} build rows, one key "
                       "x 10^4 build rows, left",
              "launches": 0, "ms": cuda_ms(expand13(sk_a, sk_cum)),
              "plain_ms": cuda_ms(expand13_plain(sk_a, sk_cum), iters=3, warmup=1),
              "device_us": device_us(expand13(sk_a, sk_cum), ("qk_mm_expand_kernel",)),
              "bound_ms": bound_ms(k13_bytes(sk_a, sk_cum))}))

    # K10 and K13p at Q4's, Q13's and Q21's largest plans and made cases
    out.extend(rank_plan_rows(dev, {q: s3[q].args["K13p" if q == "q13" else "K13p counts"][0]
                                    for q in ("q4", "q13", "q21")},
                              launches_by_path, (s_limbs, s_valid, p_s), args.seed))

    # K16 at Q7's stage, and on the same call with dates from 0001 to 9999
    # (before 1970 too) and 5% nulls in place of l_shipdate
    (k16_call, *_), _ = s3["q7"].args["K16"]

    def check_k16(label, call) -> float:
        mk, ck, ok = call.launch()
        mp, cp, op = call.plain()
        if not (torch.equal(mk, mp) and int(ck) == int(cp)):
            fail(f"K16 {label}: mask/count differ from the plain version")
        err = 0.0
        for a, b in zip(ok, op):
            if a.dtype != b.dtype:
                fail(f"K16 {label}: output dtype {a.dtype} != the plain version's {b.dtype}")
            if a.is_floating_point():
                if not torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True):
                    fail(f"K16 {label}: values beyond rtol 1e-12 of the plain version")
                both = ~(torch.isnan(a) | torch.isnan(b))
                err = max(err, float((a[both] - b[both]).abs().max()))
            elif not torch.equal(a, b):
                fail(f"K16 {label}: values differ from the plain version")
        print(f"K16 {label}: mask ({int(ck)} live of {mk.shape[0]}) and {len(ok)} outputs "
              f"match the plain version (max abs err {err})")
        return err

    err16 = check_k16("Q7", k16_call)
    if "l_shipdate" not in k16_call.inputs:
        fail("K16: Q7's stage does not read l_shipdate")
    n16 = k16_call.valid.shape[0]
    dd = torch.randint(-719162, 2932896, (n16,), generator=g13, dtype=torch.int64)
    dd[torch.rand(n16, generator=g13) < 0.05] = -(2**31)
    wide_dates = dict(k16_call.inputs)
    wide_dates["l_shipdate"] = dd.to(torch.int32).to(dev)
    err16 = max(err16, check_k16("Q7, dates 0001-9999 with nulls",
                                 dataclasses.replace(k16_call, inputs=wide_dates)))
    k16_in = list(k16_call.inputs.values()) + [k16_call.valid]
    out.append(dict(
        name="K16 in-stage elementwise", route="triton", source="quokka_tpu_torch/ops/stagefuse.py",
        replaces="quokka_tpu/ops/stagefuse.py:113", launches=launches_by_path["q7"]["K16"],
        max_abs_err=err16, ms=cuda_ms(k16_call.launch), plain_ms=cuda_ms(k16_call.plain),
        bound_ms=bound_ms(nbytes(*k16_in) + n16 + 4 + sum(
            n16 * torch.empty(0, dtype=dt).element_size() for dt in k16_call.out_dtypes)),
        bound_by="bytes", library_ms=None,
        shape=f"Q7: {n16} rows, {len(k16_in) - 1} inputs, {len(k16_call.outputs)} outputs",
        device_us=device_us(k16_call.launch, ("qk_elemwise",))))

    # -- the time-series kernels: K18, K19, K20a, K20b ---------------------------
    def same(label, a, b) -> None:
        for x, y in zip(a, b):
            if x.dtype != y.dtype or not torch.equal(x, y):
                if not (x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
                        and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)])):
                    fail(f"{label}: differs from the plain version")

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    qu, tr = ticks["quotes"], ticks["trades"]
    nq_pad = config.bucket_size(len(qu["time"]))

    def tick_ops(cols, sym=None, coarse=False):
        """(hash limbs of the symbol, time) as the asof join builds them."""
        table = bridge.HostTable({"symbol": cols["symbol"] if sym is None else sym,
                                  "time": cols["time"] // 1000 * 1000 if coarse
                                  else cols["time"]},
                                 dictionaries={"symbol": np.array(TS_SYMS, dtype=object)})
        b = bridge.host_to_device(table, dev)
        return key_limbs(b, ["symbol"]) + [b.columns["time"].data], b.valid

    def k18_case(label, q_ops, q_valid, t_ops, t_valid, pad=None):
        if pad is not None:
            q_ops = [bridge.pad_tail(o, pad) for o in q_ops]
            q_valid = bridge.pad_tail(q_valid, pad)
        so, pm, nv = asof._ss_sort_quotes(q_ops, q_valid)
        nk = len(so) - 1
        runs = asof._ss_key_runs(so, nv, nk)
        dispatched = asof.ASOF_PROBE_DISPATCH_LAUNCHES
        for upper in (True, False):
            a = asof._asof_probe_cuda(so, pm, nv, t_ops, t_valid, upper, nk, runs)
            b = asof._asof_probe_plain(so, pm, nv, t_ops, t_valid, upper, nk)
            same(f"K18 {label}, {'backward' if upper else 'forward'}", a, b)
        if asof.ASOF_PROBE_DISPATCH_LAUNCHES != dispatched:
            fail(f"K18 {label}: took the runtime-dispatch kernel")
        print(f"K18 {label}: {t_valid.shape[0]} probe rows over {pm.shape[0]} sorted quotes "
              f"({int(nv)} live, {runs.bounds.shape[0] - 1} key runs, {int(a[1].sum())} "
              "matched forward): match the plain version")

    (k18_a, _) = s4["asof"].args["K18"]
    (k18_f, _) = s4["asof forward"].args["K18"]
    for label, a in (("backward query shape", k18_a), ("forward query shape", k18_f)):
        same(f"K18 {label}", asof._asof_probe_cuda(*a), asof._asof_probe_plain(*a[:7]))
    print(f"K18 query shapes: {k18_a[4].shape[0]} probe rows over {k18_a[1].shape[0]} "
          f"sorted quotes ({k18_a[7].bounds.shape[0] - 1} key runs), both directions: match "
          "the plain version")
    q_ops, q_valid = tick_ops(qu)
    t_ops, t_valid = tick_ops(tr)
    one = np.zeros(len(qu["time"]), dtype=np.int32)
    k18_case("one symbol holding every quote", *tick_ops(qu, sym=one),
             *tick_ops(tr, sym=np.zeros(len(tr["time"]), dtype=np.int32)))
    k18_case("runs of equal timestamps (whole seconds)", *tick_ops(qu, coarse=True),
             *tick_ops(tr, coarse=True))
    k18_case("a 2^23-row quote buffer", q_ops, q_valid, t_ops, t_valid, pad=1 << 23)
    k18_case("all-invalid probe side", q_ops, q_valid, t_ops, torch.zeros_like(t_valid))
    k18_case("empty quote side", q_ops, torch.zeros_like(q_valid), t_ops, t_valid)
    # the run table's extremes and the time types: one key per quote, more
    # runs than the 16 KiB shared-memory stage holds, no key limb, float64
    # times with NaN and -0.0, int32 and float32 times
    g18 = np.random.default_rng(args.seed + 18)
    nq18, nt18 = q_valid.shape[0], t_valid.shape[0]  # the padded lengths

    def own(codes):
        return [dev_t(codes.astype(np.int32)), dev_t((codes * 31 - 7).astype(np.int32))]

    k18_case("every quote its own key", own(np.arange(nq18)) + [q_ops[-1]], q_valid,
             own(g18.integers(0, nq18, nt18)) + [t_ops[-1]], t_valid)
    k18_case("20,000 keys, past the shared-memory stage",
             own(g18.integers(0, 20_000, nq18)) + [q_ops[-1]], q_valid,
             own(g18.integers(0, 20_000, nt18)) + [t_ops[-1]], t_valid)
    k18_case("no key limb", q_ops[-1:], q_valid, t_ops[-1:], t_valid)

    def f64_times(t):
        # whole minutes from midday: ties, and thousands of zeros, half -0.0
        x = torch.round((t.double() - TS_SPAN // 2) / 60_000)
        u = torch.from_numpy(g18.random(t.shape[0])).to(dev)
        x = torch.where(u < 0.03, torch.full_like(x, float("nan")), x)
        return torch.where((u > 0.5) & (x == 0), torch.full_like(x, -0.0), x)

    k18_case("float64 times with NaN and -0.0", q_ops[:-1] + [f64_times(q_ops[-1])], q_valid,
             t_ops[:-1] + [f64_times(t_ops[-1])], t_valid)
    k18_case("int32 times", q_ops[:-1] + [q_ops[-1].to(torch.int32)], q_valid,
             t_ops[:-1] + [t_ops[-1].to(torch.int32)], t_valid)
    k18_case("float32 times", q_ops[:-1] + [(q_ops[-1] / 1000).float()], q_valid,
             t_ops[:-1] + [(t_ops[-1] / 1000).float()], t_valid)
    so, pm, nv, po, pv, up, nk = k18_a[:7]
    n_live, n_sorted = int(pv.sum()), int(nv)
    steps = max(1, n_sorted).bit_length() + 1
    n_match = int(asof._asof_probe_cuda(*k18_a)[1].sum())
    # the bytes this call's data needs: the live probe rows' limbs and
    # outputs, every row's validity byte, the valid sorted quotes (or fewer,
    # if the live rows' searches touch fewer rows) and one perm entry per match
    quote_row_b = sum(o.element_size() for o in so)
    k18_bytes = (n_live * (sum(o.element_size() for o in po) + 4 + 1) + pv.shape[0]
                 + min(n_sorted * quote_row_b, n_live * steps * quote_row_b) + n_match * 4)
    # the library yardstick: torch.searchsorted over one int64 limb,
    # (rank of the key limbs) << 40 | time, built from this call's valid
    # sorted quotes and live probe rows
    live = pv.bool()
    _, rank = torch.unique(torch.cat([torch.stack([o[:n_sorted].long() for o in so[:nk]], 1),
                                      torch.stack([o[live].long() for o in po[:nk]], 1)]),
                           dim=0, return_inverse=True)
    tq, tp = so[nk][:n_sorted].long(), po[nk][live].long()
    t0 = torch.cat([tq, tp]).min()
    if int(torch.cat([tq, tp]).max() - t0) >= 1 << 40:
        fail("K18's library yardstick: the time span does not fit 40 bits")
    qk_sorted = torch.sort((rank[:n_sorted] << 40) | (tq - t0)).values
    tk = (rank[n_sorted:] << 40) | (tp - t0)
    print(f"K18 backward query shape: {n_live} live of {pv.shape[0]} probe rows, "
          f"{n_sorted} valid of {pm.shape[0]} sorted quotes, {n_match} matched")
    out.append(dict(
        name="K18 as-of sorted-quote probe", route="cuda",
        source="quokka_tpu_torch/csrc/asof.cu", replaces="quokka_tpu/ops/asof.py:130",
        launches=launches_by_path["asof"]["K18"], max_abs_err=0.0,
        ms=cuda_ms(lambda: asof._asof_probe_cuda(*k18_a)),
        plain_ms=cuda_ms(lambda: asof._asof_probe_plain(*k18_a[:7]), iters=3, warmup=1),
        bound_ms=bound_ms(k18_bytes), bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.searchsorted(qk_sorted, tk, right=True)),
        shape=f"probe {pv.shape[0]} rows x {len(po)} limbs, {pm.shape[0]} sorted quotes",
        device_us=device_us(lambda: asof._asof_probe_cuda(*k18_a), ("qk_asof_probe",)),
        library_device_us=device_us(lambda: torch.searchsorted(qk_sorted, tk, right=True)),
        per_query={p: launches_by_path[p]["K18"] for p in ts_paths}))

    # K19 at the sort strategy's shape and on sliding's and shift's start
    # flags (the start form, where(flag, iota, -1)), and on one segment,
    # every row a segment, no quote at all, 2^23 and 0 rows; K19's segment
    # bounds at sliding's and shift's query shapes, at the sort strategy's
    # row count and on the same made flags
    g19 = torch.Generator(device="cpu").manual_seed(args.seed + 19)

    def start_form(fl):
        io = torch.arange(fl.shape[0], dtype=torch.int32, device=fl.device)
        return torch.where(fl, io, torch.full_like(io, -1)), fl

    flags_of = {p: s4[p].args["K19 bounds"][0][0] for p in ("sliding", "shift")}
    k19_cases = {"asof sort query shape": s4["asof sort"].args["K19"][0],
                 **{f"{p} query shape, start form": start_form(fl) for p, fl in flags_of.items()}}
    n23 = 1 << 23
    iota23 = torch.arange(n23, dtype=torch.int32)
    made = {
        "one segment, 2^23 rows": (iota23 == 0).to(dev),
        "every row a segment, 2^23 rows": torch.ones(n23, dtype=torch.bool, device=dev),
        "random starts, 2^23 rows": (torch.rand(n23, generator=g19) < 1e-3).to(dev),
        "no start, 2^23 rows": torch.zeros(n23, dtype=torch.bool, device=dev),
        "empty": torch.zeros(0, dtype=torch.bool, device=dev),
    }
    k19_cases.update({
        "one segment, 2^23 rows": (iota23.to(dev), made["one segment, 2^23 rows"]),
        "every row a segment": (iota23.to(dev), made["every row a segment, 2^23 rows"]),
        "no quote (all -1), random starts": (torch.full((n23,), -1, dtype=torch.int32,
                                                        device=dev),
                                             made["random starts, 2^23 rows"]),
        "empty": (torch.zeros(0, dtype=torch.int32, device=dev), made["empty"]),
    })
    for label, (v, st) in k19_cases.items():
        same(f"K19 {label}", [asof._seg_fill_forward_cuda(v, st)],
             [asof._seg_fill_forward_plain(v, st)])
    print(f"K19: {', '.join(k19_cases)}: match the plain version")
    n_sort = s4["asof sort"].args["K19"][0][0].shape[0]
    kb_cases = {f"{p} query shape": fl for p, fl in flags_of.items()}
    kb_cases[f"asof sort's {n_sort} rows, random starts"] = (
        torch.rand(n_sort, generator=g19) < 1e-3).to(dev)
    kb_cases.update(made)
    for label, fl in kb_cases.items():
        same(f"K19 segment bounds {label}", asof._segment_bounds_cuda(fl),
             asof._segment_bounds_plain(fl))
    print(f"K19 segment bounds: {', '.join(kb_cases)}: match the plain version")
    k19_a = s4["asof sort"].args["K19"][0]
    k19_s = start_form(flags_of["sliding"])
    n19 = k19_s[0].shape[0]
    out.append(dict(
        name="K19 segmented fill-forward", route="cuda",
        source="quokka_tpu_torch/csrc/asof.cu", replaces="quokka_tpu/ops/asof.py:42",
        launches=launches_by_path["asof sort"]["K19"], max_abs_err=0.0,
        ms=cuda_ms(lambda: asof._seg_fill_forward_cuda(*k19_a)),
        plain_ms=cuda_ms(lambda: asof._seg_fill_forward_plain(*k19_a)),
        bound_ms=bound_ms(k19_a[0].shape[0] * (4 + 1 + 4)), bound_by="bytes",
        library_ms=None, shape=f"asof sort: {k19_a[0].shape[0]} rows",
        device_us=device_us(lambda: asof._seg_fill_forward_cuda(*k19_a), expect=K19_OPS),
        per_query={p: launches_by_path[p]["K19"] for p in ts_paths},
        # the start form at sliding's 2^20 rows, beside its one-call yardstick
        sliding_start_form={
            "shape": f"sliding's start flags, start form: {n19} rows",
            "ms": cuda_ms(lambda: asof._seg_fill_forward_cuda(*k19_s)),
            "device_us": device_us(lambda: asof._seg_fill_forward_cuda(*k19_s),
                                   expect=K19_OPS),
            "bound_ms": bound_ms(n19 * (4 + 1 + 4)),
            "cummax_ms": cuda_ms(lambda: torch.cummax(k19_s[0], 0)),
            "cummax_device_us": device_us(lambda: torch.cummax(k19_s[0], 0))}))
    kb_rows = {}
    for p, fl in flags_of.items():
        nb = fl.shape[0]
        io = torch.arange(nb, dtype=torch.int32, device=dev)
        kb_rows[p] = {
            "launches": launches_by_path[p]["K19 bounds"], "shape": f"{p}: {nb} rows",
            "ms": cuda_ms(lambda: asof._segment_bounds_cuda(fl)),
            "device_us": device_us(lambda: asof._segment_bounds_cuda(fl), expect=K19B_OPS),
            "plain_ms": cuda_ms(lambda: asof._segment_bounds_plain(fl)),
            "bound_ms": bound_ms(nb * (1 + 4 + 4)),
            # the yardsticks: one cummax gives the start half, row 20's flip
            # and cummin the end half
            "cummax_ms": cuda_ms(lambda: torch.cummax(start_form(fl)[0], 0)),
            "cummax_device_us": device_us(lambda: torch.cummax(start_form(fl)[0], 0)),
            "flip_cummin_ms": cuda_ms(lambda: ts_execs._rows_from_segment_end(io, fl, nb)),
            "flip_cummin_device_us": device_us(
                lambda: ts_execs._rows_from_segment_end(io, fl, nb))}
        print(f"K19 segment bounds at {kb_rows[p]['shape']}: {kb_rows[p]['ms']:.4f} ms, "
              f"{kb_rows[p]['device_us']:.1f} device us (bound {kb_rows[p]['bound_ms']:.5f} "
              f"ms); cummax {kb_rows[p]['cummax_ms']:.4f} ms, "
              f"{kb_rows[p]['cummax_device_us']:.1f} device us; flip + cummin "
              f"{kb_rows[p]['flip_cummin_ms']:.4f} ms, "
              f"{kb_rows[p]['flip_cummin_device_us']:.1f} device us; "
              f"{kb_rows[p]['launches']} launches a query")
    k19s = out[-1]["sliding_start_form"]
    print(f"K19 start form at sliding's {n19} rows: {k19s['ms']:.4f} ms, "
          f"{k19s['device_us']:.1f} device us; cummax {k19s['cummax_ms']:.4f} ms, "
          f"{k19s['cummax_device_us']:.1f} device us")
    kbs = kb_rows["sliding"]
    out.append(dict(
        name="K19 segment bounds (the scan both ways)", route="cuda",
        source="quokka_tpu_torch/csrc/asof.cu",
        replaces="quokka_tpu/ops/asof.py:42 + quokka_tpu/executors/ts_execs.py:928",
        launches=kbs["launches"], max_abs_err=0.0, ms=kbs["ms"], plain_ms=kbs["plain_ms"],
        bound_ms=kbs["bound_ms"], bound_by="bytes", library_ms=None, shape=kbs["shape"],
        device_us=kbs["device_us"], shift=kb_rows["shift"],
        yardsticks={k: kbs[k] for k in ("cummax_ms", "cummax_device_us", "flip_cummin_ms",
                                        "flip_cummin_device_us")},
        per_query={p: launches_by_path[p]["K19 bounds"] for p in ts_paths}))

    # K20a and K20b at the sliding window's shape, and on one symbol holding
    # every quote (windows of about 700 rows), equal timestamps, 2^23 rows
    (k20a_a, _) = s4["sliding"].args["K20a"]
    k20b_calls = [a for a, _ in s4["sliding"].every["K20b"]]
    k20b_big = max(k20b_calls, key=lambda a: a[0].shape[0])

    def segs(sym, t, pad):
        o = np.lexsort((t, sym))
        t_s = bridge.pad_tail(dev_t(t[o]), pad)
        key = bridge.pad_tail(dev_t(sym[o].astype(np.int64)), pad)
        n_ = t_s.shape[0]
        io = torch.arange(n_, dtype=torch.int32, device=dev)
        fl = (key != torch.roll(key, 1)) | (io == 0)
        ss = asof._seg_fill_forward_plain(torch.where(fl, io, torch.full_like(io, -1)), fl)
        se = io + ts_execs._rows_from_segment_end(io, fl, n_)
        return t_s, ss, se, bridge.pad_tail(dev_t(qu["bid"][o]), pad), len(o)

    k20_cases = {"sliding query shape": (*k20a_a[:3], k20b_big[0], k20a_a[0].shape[0])}
    k20_cases["one symbol holding every quote"] = segs(one, qu["time"], nq_pad)
    k20_cases["runs of equal timestamps"] = segs(qu["symbol"], qu["time"] // 1000 * 1000,
                                                  nq_pad)
    k20_cases["2^23 rows"] = segs(qu["symbol"], qu["time"], n23)
    k20_cases["empty"] = segs(one[:0], qu["time"][:0], 0)
    for label, (t_s, ss, se, x, n_live) in k20_cases.items():
        lr = ts_execs._window_bounds_cuda(t_s, ss, se, TS_SLIDE)
        same(f"K20a {label}", lr, ts_execs._window_bounds_plain(t_s, ss, se, TS_SLIDE))
        for op in ("min", "max"):
            same(f"K20b {label} {op}", [ts_execs._range_minmax_cuda(x, *lr, op)],
                 [ts_execs._range_minmax_plain(x, *lr, op)])
        wmax = int((lr[1] - lr[0])[:n_live].max()) + 1 if n_live else 0
        print(f"K20a/K20b {label}: {t_s.shape[0]} rows ({n_live} live, widest live window "
              f"{wmax} rows): match the plain version")
    for a in k20b_calls:
        same("K20b sliding query call", [ts_execs._range_minmax_cuda(*a)],
             [ts_execs._range_minmax_plain(*a)])
    # arbitrary ranges at 2^20 rows: random ones up to 3^11 rows long, a
    # twentieth degenerate (left > right), NaN in x; and one window over
    # every row
    g20 = np.random.default_rng(args.seed + 20)
    n_r = 1 << 20
    x_r = qu["bid"][:n_r].copy()
    x_r[g20.random(n_r) < 0.01] = np.nan
    l_r = g20.integers(0, n_r, n_r)
    r_r = np.minimum(l_r + g20.integers(0, 3, n_r) ** g20.integers(0, 12, n_r), n_r - 1)
    l_r[g20.random(n_r) < 0.05] = n_r - 1
    for label, lr in (("random ranges, 2^20 rows", (l_r, r_r)),
                      ("one window over all 2^20 rows", (np.zeros(n_r), np.full(n_r, n_r - 1)))):
        lr = [dev_t(a.astype(np.int32)) for a in lr]
        for op in ("min", "max"):
            same(f"K20b {label} {op}", [ts_execs._range_minmax_cuda(dev_t(x_r), *lr, op)],
                 [ts_execs._range_minmax_plain(dev_t(x_r), *lr, op)])
        print(f"K20b {label}: matches the plain version (NaN in x)")
    n20 = k20a_a[0].shape[0]
    k20_one = (*k20_cases["one symbol holding every quote"][:3], TS_SLIDE)
    out.append(dict(
        name="K20a sliding-window bounds", route="cuda",
        source="quokka_tpu_torch/csrc/window.cu",
        replaces="quokka_tpu/executors/ts_execs.py:941",
        launches=launches_by_path["sliding"]["K20a"], max_abs_err=0.0,
        ms=cuda_ms(lambda: ts_execs._window_bounds_cuda(*k20a_a)),
        plain_ms=cuda_ms(lambda: ts_execs._window_bounds_plain(*k20a_a), iters=5),
        bound_ms=bound_ms(n20 * (8 + 4 + 4 + 4 + 4)), bound_by="bytes", library_ms=None,
        shape=f"sliding: {n20} rows", per_query={p: launches_by_path[p]["K20a"]
                                                  for p in ts_paths},
        device_us=device_us(lambda: ts_execs._window_bounds_cuda(*k20a_a), expect=K20A_OPS),
        one_symbol={"shape": f"one symbol holding every quote: {k20_one[0].shape[0]} rows",
                    "ms": cuda_ms(lambda: ts_execs._window_bounds_cuda(*k20_one)),
                    "device_us": device_us(lambda: ts_execs._window_bounds_cuda(*k20_one),
                                           expect=K20A_OPS)}))
    print(f"K20a {out[-1]['one_symbol']['shape']}: {out[-1]['one_symbol']['ms']:.4f} ms, "
          f"{out[-1]['one_symbol']['device_us']:.1f} device us")
    nb20 = k20b_big[0].shape[0]
    out.append(dict(
        name="K20b sliding-window range min/max", route="cuda",
        source="quokka_tpu_torch/csrc/window.cu",
        replaces="quokka_tpu/executors/ts_execs.py:902",
        launches=launches_by_path["sliding"]["K20b"], max_abs_err=0.0,
        ms=cuda_ms(lambda: ts_execs._range_minmax_cuda(*k20b_big)),
        plain_ms=cuda_ms(lambda: ts_execs._range_minmax_plain(*k20b_big), iters=5),
        bound_ms=bound_ms(nb20 * (8 + 4 + 4 + 8)), bound_by="bytes", library_ms=None,
        shape=f"sliding: {nb20} rows, {k20b_big[3]}",
        per_query={p: launches_by_path[p]["K20b"] for p in ts_paths},
        # the whole call: both kernels
        device_us=device_us(lambda: ts_execs._range_minmax_cuda(*k20b_big), expect=K20B_OPS)))

    # -- the vector tier's kernels: K21 and K22 ----------------------------------
    def k21_agree(label, got, exp, tol):
        """Scores within tol slot by slot (NaN where NaN, -inf where -inf);
        a handle on one side only scores within 2 tol of that side's k-th."""
        gs, gh = (t.cpu().numpy() for t in got)
        es, eh = (t.cpu().numpy() for t in exp)
        if not np.array_equal(np.isnan(gs), np.isnan(es)):
            fail(f"K21 {label}: NaN slots differ from the plain version")
        with np.errstate(invalid="ignore"):  # -inf - -inf where both are -inf
            diff = np.where((gs == es) | np.isnan(gs), 0.0, np.abs(gs - es))
        err = float(diff.max()) if diff.size else 0.0
        if not err <= tol:
            fail(f"K21 {label}: scores {err:.3g} from the plain version's (tolerance {tol})")
        differ = np.flatnonzero(~(np.sort(gh, 1) == np.sort(eh, 1)).all(1))
        for qi in differ:
            for s_, h_, other in ((gs, gh, eh), (es, eh, gh)):
                for j in np.flatnonzero(~np.isin(h_[qi], other[qi])):
                    if not abs(float(s_[qi, j]) - float(s_[qi, -1])) <= 2 * tol:
                        fail(f"K21 {label}: query {qi} takes row handle {h_[qi, j]} "
                             "away from the k-th score")
        return err, len(differ)

    (k21_a, _) = s5["vector"].args["K21"]
    k21_q, k21_v, k21_valid, k21_k = k21_a[:4]
    k21_err, k21_differ = k21_agree("vector query shape", vops.sims_topk_cuda(*k21_a),
                                    vops.sims_topk_plain(*k21_a), 1e-5)
    print(f"K21 vector query shape: {k21_q.shape[0]} queries x {k21_v.shape[0]} rows x "
          f"{k21_v.shape[1]}, k {k21_k}: within {k21_err:.3g} of the plain version "
          f"({k21_differ} queries swap a near-tied row)")
    # Q = 256 over one 2^20-row batch of the corpus, and over made batches of
    # d = 1, 7 and 768 with invalid and null rows, at k = 1, 10 and 100; each
    # case also merges the same batch again into its own result (every
    # candidate ties a state entry, which must win); and fewer rows than k
    g21 = torch.Generator(device=dev).manual_seed(args.seed + 21)
    q256 = torch.from_numpy(_unit_f32(vd["queries"][:256])).to(dev)

    def made_batch(d, n=1 << 20):
        v = torch.randn((n, d), generator=g21, device=dev, dtype=torch.float64)
        v[torch.rand(n, generator=g21, device=dev) < 0.01] = 0.0  # null rows
        v[7] = v[33]  # an exact tie
        v[20, 0] = float("nan")
        return v, torch.rand(n, generator=g21, device=dev) < 0.95

    def q_of(d):
        x = torch.randn((256, d), generator=g21, device=dev)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)

    k21_cases = {"corpus batch, d = 100": (q256, k21_v, k21_valid, 1e-5)}
    for d, tol in ((1, 0.0), (7, 1e-6), (768, 1e-5)):
        k21_cases[f"made batch, d = {d}"] = (q_of(d), *made_batch(d), tol)
    for label, (q_, v_, valid_, tol) in k21_cases.items():
        for k in (1, 10, 100):
            st = vops.empty_state(q_.shape[0], k, dev)
            a = vops.sims_topk_cuda(q_, v_, valid_, k, *st, 0)
            k21_agree(f"{label}, k = {k}", a, vops.sims_topk_plain(q_, v_, valid_, k, *st, 0),
                      tol)
            again = vops.sims_topk_cuda(q_, v_, valid_, k, *a, 1)
            k21_agree(f"{label}, k = {k}, merged again", again,
                      vops.sims_topk_plain(q_, v_, valid_, k, *a, 1), tol)
            # each row of the second batch ties its own row in the state,
            # which the stable merge keeps ahead of it
            for hq in again[1].cpu().numpy():
                kept = set(hq[(hq >> 32) == 0].tolist())
                first = {int(x): j for j, x in reversed(list(enumerate(hq)))}
                for j, x in enumerate(hq):
                    if x >> 32 == 1 and not (int(x & 0xFFFFFFFF) in kept
                                              and first[int(x & 0xFFFFFFFF)] < j):
                        fail(f"K21 {label}, k = {k}: a row of the second batch went ahead "
                             "of its tie in the running state")
        del v_
    q9, (v50, valid50) = q_of(9), made_batch(9, 50)
    st = vops.empty_state(256, 100, dev)
    few = vops.sims_topk_cuda(q9, v50, valid50, 100, *st, 0)
    k21_agree("50 rows, k = 100", few, vops.sims_topk_plain(q9, v50, valid50, 100, *st, 0),
              1e-6)
    if int((few[1] >= 0).sum(1).min()) != 50:
        fail("K21 50 rows, k = 100: not every row filled a slot")
    print(f"K21: {', '.join(k21_cases)} at k = 1, 10, 100 (and merged again), and 50 rows "
          "at k = 100: match the plain version")
    del k21_cases
    n21 = int(k21_valid.sum())
    nq21, d21 = k21_q.shape
    v_unit = k21_v.to(torch.float32)
    v_unit = v_unit / torch.clamp(torch.linalg.vector_norm(v_unit, dim=1, keepdim=True),
                                  min=1e-12)

    def k21_library():
        # the yardstick: chunked torch.topk(q @ v_norm.T, k); the port never calls it
        best = None
        for r0 in range(0, v_unit.shape[0], 1 << 16):
            top = torch.topk(k21_q @ v_unit[r0:r0 + (1 << 16)].T, k21_k, dim=1)
            best = top if best is None else torch.topk(
                torch.cat([best.values, top.values], 1), k21_k, dim=1)
        return best

    k21_ops = 2 * nq21 * n21 * d21
    k21_bytes = (n21 * d21 * k21_v.element_size() + k21_v.shape[0] + nq21 * d21 * 4
                 + 2 * nq21 * k21_k * 12)
    out.append(dict(
        name="K21 fused cosine top-k", route="cuda", source="quokka_tpu_torch/csrc/vector.cu",
        replaces="quokka_tpu/executors/vector.py:49", launches=launches_by_path["vector"]["K21"],
        max_abs_err=k21_err,
        ms=cuda_ms(lambda: vops.sims_topk_cuda(*k21_a), iters=5, warmup=1),
        plain_ms=cuda_ms(lambda: vops.sims_topk_plain(*k21_a), iters=2, warmup=1),
        bound_ms=max(k21_ops / FP32_FLOP_PER_S, k21_bytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if k21_ops / FP32_FLOP_PER_S > k21_bytes / HBM_BYTES_PER_S
        else "bytes",
        library_ms=cuda_ms(k21_library, iters=3, warmup=1),
        shape=f"vector: {nq21} queries x {k21_v.shape[0]} rows ({n21} live) x {d21}, "
              f"k {k21_k}",
        device_us=device_us(lambda: vops.sims_topk_cuda(*k21_a),
                            ("qk_sims_stage_kernel", "qk_sims_topk_kernel",
                             "qk_topk_merge_kernel"), iters=3),
        per_query={p: launches_by_path[p]["K21"] for p in ("vector", "ann")}))
    del v_unit

    # K22 at the Gramian's shape (lineitem's four columns), and over made
    # columns of every type at d = 1, 4, 17 and 64 with invalid rows and NaN
    (k22_a, _) = s5["gramian"].args["K22"]

    def k22_same(label, cols, valid_):
        g, s_ = lops.gramian_cuda(cols, valid_)
        gp, sp = lops.gramian_plain(cols, valid_)
        for x, y in ((g, gp), (s_, sp)):
            if not (torch.equal(torch.isnan(x), torch.isnan(y))
                    and torch.allclose(x, y, rtol=1e-9, atol=0, equal_nan=True)):
                fail(f"K22 {label}: beyond rtol 1e-9 of the plain version")
        fin = ~torch.isnan(g)
        return float(((g - gp).abs() / gp.abs().clamp(min=1e-300))[fin].max())

    k22_rel = k22_same("gramian query shape", *k22_a)
    g22 = torch.Generator(device=dev).manual_seed(args.seed + 22)
    for d in (1, 4, 17, 64):
        n = 1 << 20
        cols = []
        for j in range(d):
            x = torch.randn(n, generator=g22, device=dev, dtype=torch.float64) * 100
            if j % 3 == 1:
                x = x.round().to(torch.int64)
            elif j % 3 == 2:
                x[torch.rand(n, generator=g22, device=dev) < 1e-3] = float("nan")
            cols.append(x)
        k22_same(f"d = {d}", cols, torch.rand(n, generator=g22, device=dev) < 0.9)
    print(f"K22: gramian query shape ({k22_a[1].shape[0]} rows x {len(k22_a[0])}, max rel "
          f"{k22_rel:.3g}) and d = 1, 4, 17, 64 with invalid rows: match the plain version")
    n22 = k22_a[1].shape[0]
    d22 = len(k22_a[0])
    # the yardstick: one torch.mm(a.T, a) over a = [masked float32-cast
    # columns | valid] in float64, built outside the timing, gives m^T m and
    # the column sums (the last column); the port never calls it
    a22 = torch.cat([lops._masked_f32(*k22_a).to(torch.float64),
                     k22_a[1][:, None].to(torch.float64)], 1)
    lib22 = torch.mm(a22.T, a22)
    for x, y in zip((lib22[:d22, :d22], lib22[:d22, d22]), lops.gramian_plain(*k22_a)):
        if not torch.allclose(x, y, rtol=1e-9, atol=0, equal_nan=True):
            fail("K22's yardstick torch.mm(a.T, a) is not the plain version's function")
    out.append(dict(
        name="K22 masked Gramian", route="cuda", source="quokka_tpu_torch/csrc/linalg.cu",
        replaces="quokka_tpu/executors/linalg.py:37",
        launches=launches_by_path["gramian"]["K22"], max_abs_err=float(
            (lops.gramian_cuda(*k22_a)[0] - lops.gramian_plain(*k22_a)[0]).abs().max()),
        ms=cuda_ms(lambda: lops.gramian_cuda(*k22_a)),
        plain_ms=cuda_ms(lambda: lops.gramian_plain(*k22_a)),
        bound_ms=bound_ms(nbytes(*k22_a[0], k22_a[1]) + 8 * (d22 * (d22 + 1) // 2 + d22)),
        bound_by="bytes", library_ms=cuda_ms(lambda: torch.mm(a22.T, a22)),
        shape=f"gramian: {n22} rows x {d22} columns",
        device_us=device_us(lambda: lops.gramian_cuda(*k22_a),
                            ("qk_gram_small_kernel", "qk_gram_wide_kernel")),
        per_query={p: launches_by_path[p]["K22"] for p in ("gramian", "covariance")}))
    del a22, lib22

    # K17 at Q3 compacted's largest split; also at 64 parts, with empty parts
    # and all rows invalid, at the same length
    (k17_p, k17_v, k17_n), _ = s6["q3 compacted"].args["K17"]
    r17 = np.random.default_rng(args.seed)
    big17 = (1 << 24) + 3
    p17 = torch.from_numpy(r17.integers(-1, 65, big17).astype(np.int32)).to(dev)
    v17 = torch.from_numpy(r17.random(big17) < 0.8).to(dev)
    p17_2 = p17 % 2  # made here, so that no timed call below makes it
    k17_cases = (("query shape", k17_p, k17_v, k17_n),
                 ("64 parts", k17_p * 31 % 64, k17_v, 64),
                 ("empty parts", torch.where(k17_p == 0, 0, k17_n - 1).to(torch.int32), k17_v,
                  max(k17_n, 3)),
                 ("all invalid", k17_p, torch.zeros_like(k17_v), k17_n),
                 ("2^24 + 3 rows, 2 parts", p17_2, v17, 2),
                 ("2^24 + 3 rows, 64 parts, ids out of range", p17, v17, 64),
                 ("2^24 + 3 rows, 1 part", p17, v17, 1))
    for label, p_, v_, n_ in k17_cases:
        got, want = kernels.partition_plan(p_, v_, n_), kernels.partition_plan_plain(p_, v_, n_)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"K17 {label}: perm / counts / offsets differ from the plain version")
    n17 = k17_v.shape[0]

    def k17_library():
        # the yardstick: one stable torch.sort; the port never calls it
        return torch.sort(torch.where(k17_v, k17_p, k17_n), stable=True).indices

    if not torch.equal(k17_library().to(torch.int32),
                       kernels.partition_plan(k17_p, k17_v, k17_n)[0]):
        fail("K17's yardstick torch.sort is not the plan's permutation")
    print(f"K17: {', '.join(c[0] for c in k17_cases)} ({n17} rows at the query shape) match "
          "the plain version")
    out.append(dict(
        name="K17 stable radix partition plan", route="cuda",
        source="quokka_tpu_torch/csrc/partition.cu", replaces="quokka_tpu/ops/kernels.py:417",
        launches=launches_by_path["q3 compacted"]["K17"], max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.partition_plan(k17_p, k17_v, k17_n)),
        plain_ms=cuda_ms(lambda: kernels.partition_plan_plain(k17_p, k17_v, k17_n), iters=5),
        bound_ms=bound_ms(9 * n17 + 8 * k17_n), bound_by="bytes",
        library_ms=cuda_ms(k17_library), shape=f"q3 compacted: {n17} rows, {k17_n} parts",
        device_us=device_us(lambda: kernels.partition_plan(k17_p, k17_v, k17_n),
                            expect=K17_OPS),
        per_query={p: launches_by_path[p]["K17"] for p in sorted(compacted_paths)},
        big={"shape": f"{big17} rows, 2 parts", "launches": 0,
             "ms": cuda_ms(lambda: kernels.partition_plan(p17_2, v17, 2)),
             "plain_ms": cuda_ms(lambda: kernels.partition_plan_plain(p17_2, v17, 2), iters=3),
             "device_us": device_us(lambda: kernels.partition_plan(p17_2, v17, 2),
                                    expect=K17_OPS),
             "bound_ms": bound_ms(9 * big17 + 16)}))
    del p17, p17_2, v17

    # K8 at Q3's largest compacting concat, then the cases beyond it, each
    # through concat_batches and bit for bit against the plain version
    c_parts, c_per_col, c_dicts, c_total, c_padded = hcap.args["K8"][0]

    def k8_check(label, parts):
        per_col, dicts = bridge._concat_parts(parts)
        total = sum(b.count_valid() for b in parts)
        before = bridge.CONCAT_LAUNCHES
        got = bridge.concat_batches(parts)
        launched = bridge.CONCAT_LAUNCHES - before
        want = bridge.compact_concat_plain(parts, per_col, dicts, total,
                                           config.bucket_size(total))
        torch.cuda.synchronize()
        if launched != -(-len(per_col) // bridge.CONCAT_MAX_COLUMNS) or not same_batch(got, want):
            fail(f"K8 {label}: {launched} launches; the concat differs from the plain version")
        return (f"{label} ({len(parts)} parts, {total} of {sum(b.padded_len for b in parts)} "
                f"rows live, {len(per_col)} columns, {launched} launches)")

    k8_done = [k8_check("Q3's largest concat", c_parts)]
    for label in K8_CASES:
        k8_done.append(k8_check(label, k8_parts(dev, label, args.seed)))
    print(f"K8: {'; '.join(k8_done)}: match the plain version bit for bit")
    c_lens = [b.padded_len for b in c_parts]
    c_widths = [bridge._row_bytes(bridge._promoted(p), p[0].shape[1:]) for p in c_per_col.values()]
    c_bytes = sum(c_lens) + c_total * sum(c_widths) + c_padded * (sum(c_widths) + 1)

    def k8_call():
        return bridge.compact_concat(c_parts, c_per_col, c_dicts, c_total, c_padded)

    out.append(dict(
        name="K8 compact-concat", route="cuda", source="quokka_tpu_torch/csrc/concat.cu",
        replaces="quokka_tpu/ops/bridge.py:382", launches=launches_by_path["q3"]["K8"],
        max_abs_err=0.0, ms=cuda_ms(k8_call),
        plain_ms=cuda_ms(lambda: bridge.compact_concat_plain(c_parts, c_per_col, c_dicts,
                                                             c_total, c_padded)),
        bound_ms=bound_ms(c_bytes), bound_by="bytes", library_ms=None,
        shape=f"q3's largest: {len(c_parts)} parts of {c_lens} rows, {c_total} live, bucket "
              f"{c_padded}, {len(c_widths)} columns of {c_widths} B",
        device_us=device_us(k8_call, expect=("qk_concat_kernel",)),
        concat_ms=cuda_ms(lambda: bridge.concat_batches(c_parts)),
        per_query={p: launches_by_path[p]["K8"] for p in paths},
        concats_per_query={p: concat_calls[p] for p in paths}))

    # K26 at the skew join's largest split (both modes, with and without
    # masks), and at Q3's largest split shape
    (k26_l, k26_p, k26_v, k26_n, k26_f, _), _ = s6["skewjoin"].args["K26"]

    def k26_check(label, limbs_, pids_, valid_, n_, fat_):
        for mode in ("salt", "replicate"):
            for masks in (True, False):
                a = kernels.adapt_split(limbs_, pids_, valid_, n_, fat_, mode, masks)
                b = kernels.adapt_split_plain(limbs_, pids_, valid_, n_, fat_, mode, masks)
                if not all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b)):
                    fail(f"K26 {label}, {mode}: ids / masks / counts differ from the plain "
                         "version")

    k26_check("skew join", k26_l, k26_p, k26_v, k26_n, k26_f)
    k26_check("Q3 largest split", q3_l4, None, q3_v4, q3_n4, q3_n4 - 1)
    k26_check("Q3 largest split, 7 parts", q3_l4, None, q3_v4, 7, 3)
    print("K26: the skew join's and Q3's largest splits, salt and replicate, match the "
          "plain version")

    def k26_bytes(limbs_, valid_, n_):
        m = valid_.shape[0]
        return nbytes(*limbs_, valid_) + m * (4 + n_) + 4 * n_

    def k26_call(limbs_, pids_, valid_, n_, fat_, mode="salt"):
        return lambda: kernels.adapt_split(limbs_, pids_, valid_, n_, fat_, mode)

    out.append(dict(
        name="K26 adaptive split (salt / replicate)", route="cuda",
        source="quokka_tpu_torch/csrc/partition.cu", replaces="quokka_tpu/planner/adapt.py:57",
        launches=launches_by_path["skewjoin"]["K26"], max_abs_err=0.0,
        ms=cuda_ms(k26_call(k26_l, k26_p, k26_v, k26_n, k26_f)),
        plain_ms=cuda_ms(lambda: kernels.adapt_split_plain(k26_l, k26_p, k26_v, k26_n, k26_f,
                                                           "salt")),
        bound_ms=bound_ms(k26_bytes(k26_l, k26_v, k26_n)), bound_by="bytes", library_ms=None,
        shape=f"skewjoin: {k26_v.shape[0]} rows, {len(k26_l)} limbs, {k26_n} parts, salt",
        device_us=device_us(k26_call(k26_l, k26_p, k26_v, k26_n, k26_f), ("qk_adapt_kernel",)),
        per_query={p: launches_by_path[p]["K26"] for p in ("skewjoin", "skewjoin static")},
        q3={"shape": f"{q3_v4.shape[0]} rows, {len(q3_l4)} limbs, {q3_n4} parts, replicate",
            "launches": launches_by_path["q3"]["K26"],
            "ms": cuda_ms(k26_call(q3_l4, None, q3_v4, q3_n4, q3_n4 - 1, "replicate")),
            "plain_ms": cuda_ms(lambda: kernels.adapt_split_plain(
                q3_l4, None, q3_v4, q3_n4, q3_n4 - 1, "replicate")),
            "device_us": device_us(k26_call(q3_l4, None, q3_v4, q3_n4, q3_n4 - 1, "replicate"),
                                   ("qk_adapt_kernel",)),
            "bound_ms": bound_ms(k26_bytes(q3_l4, q3_v4, q3_n4))}))

    # K6 at Q1 sort's largest call (the Q1 batch after K1 and K5)
    (k6_a, _) = s6["q1 sort"].args["K6"]
    k6_fc, k6_ic, k6_co, k6_st, k6_g, k6_v = k6_a
    got6, want6 = fuse.onehot_agg_cuda(*k6_a), fuse.onehot_agg_plain(*k6_a)
    if not (torch.equal(got6[1], want6[1]) and torch.equal(got6[2], want6[2])
            and torch.equal(got6[3], want6[3])):
        fail("K6 counts / integer sums / smallest rows differ from the plain version")
    if not (torch.equal(torch.isnan(got6[0]), torch.isnan(want6[0]))
            and torch.allclose(got6[0], want6[0], rtol=1e-9, atol=0, equal_nan=True)):
        fail("K6 float sums beyond rtol 1e-9 of the plain version")
    fin6 = ~torch.isnan(want6[0])
    err6 = float((got6[0] - want6[0])[fin6].abs().max()) if bool(fin6.any()) else 0.0
    # the yardstick: one float64 torch.mm(onehot.T, stacked) over the
    # [n, G + 1] one-hot and the masked columns with validity last, built
    # outside the timing (the reference's matmul); the port never calls it
    gid6 = fuse._bucket_ids(k6_co, k6_st, k6_v, k6_g)
    onehot6 = (gid6[:, None] == torch.arange(k6_g + 1, device=dev)[None, :]).to(torch.float64)
    stacked6 = torch.stack([torch.where(k6_v, c, torch.zeros((), dtype=c.dtype, device=dev))
                            for c in k6_fc] + [k6_v.to(torch.float64)], 1)
    lib6 = torch.mm(onehot6.T, stacked6)[:k6_g]
    if not (torch.allclose(lib6[:, :-1].T, want6[0], rtol=1e-9, atol=0, equal_nan=True)
            and torch.equal(lib6[:, -1].to(torch.int32), want6[2])):
        fail("K6's yardstick torch.mm(onehot.T, stacked) is not the plain version's function")
    n6 = k6_v.shape[0]
    print(f"K6 Q1 sort: {n6} rows, {k6_g + 1} buckets, {len(k6_fc)} float and {len(k6_ic)} "
          f"integer columns: match the plain version (max abs err {err6})")
    out.append(dict(
        name="K6 one-hot small-key partial aggregate", route="cuda",
        source="quokka_tpu_torch/csrc/onehot.cu", replaces="quokka_tpu/ops/fuse.py:367",
        launches=launches_by_path["q1 sort"]["K6"], max_abs_err=err6,
        ms=cuda_ms(lambda: fuse.onehot_agg_cuda(*k6_a)),
        plain_ms=cuda_ms(lambda: fuse.onehot_agg_plain(*k6_a)),
        bound_ms=bound_ms(nbytes(*k6_fc, *k6_ic, *k6_co, k6_v)
                          + k6_g * (8 * (len(k6_fc) + len(k6_ic)) + 12)),
        bound_by="bytes", library_ms=cuda_ms(lambda: torch.mm(onehot6.T, stacked6)),
        shape=f"q1 sort: {n6} rows, {k6_g + 1} buckets, {len(k6_fc)} float + {len(k6_ic)} "
              "integer columns",
        device_us=device_us(lambda: fuse.onehot_agg_cuda(*k6_a), ("qk_bucket_",)),
        per_query={p: launches_by_path[p]["K6"] for p in sorted(sort_paths)}))
    del onehot6, stacked6

    # K23 at Q1's and Q3's largest landed batches, then the layouts beyond
    # them: NaN / -0.0 dictionaries, uint16 codes, a plan that widens then
    # degrades, an all-pass layout and a 0-row batch, each bit for bit
    k23_caps = {}
    for q in ("q1", "q3"):
        with Capture({"K23": (pack, "pack_put", lambda leaves, device: leaves[0].padded)}) \
                as cap:
            collect_numpy(tpch_stream(q, ctx, tables), q)
        k23_caps[q] = cap.args["K23"][0][0]
    pack._PLANS.clear()
    k23 = {q: check_k23(dev, f"{q}'s largest batch", leaves) for q, leaves in k23_caps.items()}
    k23_layouts = {q: c["kinds"] for q, c in k23.items()}
    for label, seq in k23_cases(args.seed):
        pack._PLANS.clear()
        k23_layouts[label] = [check_k23(dev, f"{label}, batch {i}", leaves)["kinds"]
                              for i, leaves in enumerate(seq)]
    print(f"K23: the layouts {k23_layouts} match the plain version and the input bit for bit")

    def k23_row(c):
        st = c["st"]
        return dict(ms=cuda_ms(lambda: pack.decode_launch(st)),
                    plain_ms=cuda_ms(lambda: pack.decode_plain(c["layout"], st.wires)),
                    bound_ms=bound_ms(c["read"] + c["write"]),
                    device_us=device_us(lambda: pack.decode_launch(st), ("qk_decode",)),
                    shape=f"{st.outs[0].shape[0]} rows, layout {c['kinds']}, "
                          f"{c['read']} B read, {c['write']} B written")

    row1, row3 = k23_row(k23["q1"]), k23_row(k23["q3"])
    out.append(dict(
        name="K23 wire decode", route="cuda", source="quokka_tpu_torch/csrc/pack.cu",
        replaces="quokka_tpu/ops/pack.py:128", launches=launches_by_path["q1"]["K23"],
        max_abs_err=0.0, bound_by="bytes", library_ms=None, **row1,
        per_query={p: launches_by_path[p]["K23"] for p in paths},
        q3={"launches": launches_by_path["q3"]["K23"], **row3}))
    report["k23_layouts"] = k23_layouts
    del k23, k23_caps

    # K24 at Q3's largest shuffle and at 1, 2, 8 and 64 shards; K14 at Q3's
    # largest call, with duplicate build keys, no matches and no valid row
    out.extend(mesh_kernel_rows(dev, mesh_cap, mesh_launches, args.seed))
    del mesh_cap

    # the torch-primitive rows at Q3's shapes: time, device time, bound
    def t_row(row, what, fn, n_bytes, calls, query="q3"):
        t_rows.append(dict(row=row, what=what, query=query, calls_per_query=calls,
                           ms=cuda_ms(fn, iters=10), device_us=device_us(fn),
                           bound_ms=bound_ms(n_bytes)))
        print(f"row {row} {what}: {t_rows[-1]['ms']:.4f} ms, "
              f"{t_rows[-1]['device_us']:.1f} device us, bound {t_rows[-1]['bound_ms']:.5f} ms, "
              f"{calls} calls per {query}")

    (g_cols, g_idx), _ = hcap.args["row 7 gather"]
    g_out = join.gather_columns(g_cols, g_idx)
    t_row(7, "join payload gather (index_select per column)",
          lambda: join.gather_columns(g_cols, g_idx),
          nbytes(g_idx) + 2 * sum(nbytes(c.data if hasattr(c, "data") else c.codes)
                                  for c in g_out.values()),
          hcap.calls["row 7 gather"])
    (mk_b, mk_m), _ = s4["sliding"].args["mask"]
    t_row(52, "mask and live count (kernels.apply_mask, `_mask_and_count`)",
          lambda: kernels.apply_mask(mk_b, mk_m).nrows_dev,
          nbytes(mk_b.valid, mk_m) + mk_m.shape[0] + 4, s4["sliding"].calls["mask"], "sliding")
    (ct_m,), _ = hcap.args["row 14 count"]
    t_row(14, "output live count (count_true)", lambda: join._count_true(ct_m),
          nbytes(ct_m) + 4, hcap.calls["row 14 count"])
    (d_tbl, d_ok), _ = hcap.args["row 14 distinct"]
    t_row(14, "build distinct count (hashtable)", lambda: join._distinct_from_table(d_tbl, d_ok),
          nbytes(d_tbl, d_ok) + 16, hcap.calls["row 14 distinct"])
    (h_limbs, h_nv), _ = scap.args["row 14 dup"]
    t_row(14, "build duplicate check (sorted)", lambda: join._sorted_has_dup(h_limbs, h_nv),
          nbytes(*h_limbs) + 1, scap.calls["row 14 dup"])
    (ls_keys,), _ = scap.args["row 15 sort"]
    t_row(15, "stable lexicographic sort (build keys)", lambda: kernels.lexsort_perm(ls_keys),
          nbytes(*ls_keys) + ls_keys[0].shape[0] * 8, scap.calls["row 15 sort"])
    (r9_a, r9_v, r9_op), _ = s4["sliding"].args["row 9 reduce"]
    t_row(9, f"reduce_array ({r9_op}, the sliding watermark)",
          lambda: kernels.reduce_array(r9_a, r9_v, r9_op), nbytes(r9_a, r9_v) + 8,
          s4["sliding"].calls["row 9 reduce"], "sliding")
    # row 20, K19's plain segment ends: timed at sliding's flags as a
    # yardstick, with the calls the card path makes (none)
    r20_fl = flags_of["sliding"]
    r20_n = r20_fl.shape[0]
    r20_io = torch.arange(r20_n, dtype=torch.int32, device=dev)
    t_row(20, "rows to the segment end (flip + cummin)",
          lambda: ts_execs._rows_from_segment_end(r20_io, r20_fl, r20_n),
          nbytes(r20_io, r20_fl) + r20_n * 4, 0, "sliding")
    k20b_x, k20b_l, k20b_r, _ = k20b_big

    def prefix_window_sums():
        cs = torch.cumsum(k20b_x, 0)
        lft = k20b_l.long()
        before = torch.where(lft > 0, cs[torch.clamp(lft - 1, min=0)],
                             torch.zeros((), dtype=cs.dtype, device=cs.device))
        return cs[k20b_r.long()] - before

    t_row(20, "rolling sum as a difference of prefix sums (cumsum + 2 gathers)",
          prefix_window_sums, nbytes(k20b_x, k20b_l, k20b_r) + k20b_x.shape[0] * 8,
          s4["sliding"].calls["K20a"] * sum(
              op in ("sum", "count") for _, op, _ in
              plan_aggregation(sqlparse.parse_select_list(sliding_aggs)).partials), "sliding")
    report["t_rows"] = t_rows

    for kk in out:
        print(f"{kk['name']}: {kk['launches']} launches on its path, {kk['ms']:.4f} ms per "
              f"call, {kk['device_us']:.1f} device us per call, bound {kk['bound_ms']:.5f} ms "
              f"({kk['shape']}); plain {kk['plain_ms']:.4f} ms")
        if "concat_ms" in kk:
            print(f"  the whole concat_batches call: {kk['concat_ms']:.4f} ms")
        if kk.get("library_device_us") is not None:
            print(f"  library: {kk['library_ms']:.4f} ms, {kk['library_device_us']:.1f} "
                  "device us per call")
        if "split_device_us" in kk:
            print(f"  device us by part: {kk['split_device_us']}; a stable torch.sort of the "
                  f"packed key (a yardstick, not the same function) {kk['library_ms']:.4f} ms")
        for sub in ("q3", "q4", "q7", "q13", "q21", "tumbling", "hopping", "build", "skew",
                    "big"):
            if sub in kk:
                v = kk[sub]
                print(f"  {sub}: {v['launches']} launches, {v['ms']:.4f} ms, "
                      f"{v['device_us']:.1f} device us, bound {v['bound_ms']:.5f} ms "
                      f"({v['shape']}); plain {v['plain_ms']:.4f} ms"
                      + (f"; device us by part {v['split_device_us']}"
                         if "split_device_us" in v else ""))
    report["kernels"] = out
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_us", "per_query",
            "split_device_us")
    print(json.dumps({"kernels": [{k: kk[k] for k in keep if k in kk} for kk in out]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(dev),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
