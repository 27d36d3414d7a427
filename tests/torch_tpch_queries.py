"""TPC-H Q2, Q6, Q8, Q9, Q10, Q11, Q12, Q14, Q15, Q16, Q17, Q18, Q20 and Q22
for the port's CPU tests (tests/test_torch_tpch_*.py): each query written
as tests/test_tpch.py and tests/test_tpch2.py write it, runnable through
either package (quokka_tpu or quokka_tpu_torch), with its pandas oracle
and the comparison of two results.

A query takes ``(pkg, ctx, paths, params)`` and returns the collected
DataFrame; ``params(dfs)`` holds the constants the tests derive from the
data (Q11's nation and cutoff), the same for both packages.  Q15 and Q22
collect a scalar first (the top revenue, the average balance) through the
package under test, as the original tests do.

Tolerances: keys and counts exact, floats rtol 1e-9 (summation order);
grouped results compare after a sort on their keys.
"""

import datetime

import numpy as np
import pandas as pd

Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def streams(ctx, paths):
    return {name: ctx.read_parquet(p) for name, p in paths.items()}


def params(dfs):
    """Constants derived from the data, the same for every package: Q11's
    modal supplier nation and its 80th-percentile cutoff (the spec's
    0.0001 / SF fraction selects nothing at this size)."""
    ps, su, n = dfs["partsupp"], dfs["supplier"], dfs["nation"]
    nat_key = int(su.s_nationkey.mode()[0])
    j = ps[ps.ps_suppkey.isin(su[su.s_nationkey == nat_key].s_suppkey)]
    value = (j.ps_supplycost * j.ps_availqty).groupby(j.ps_partkey).sum()
    return {"q11_nation": n[n.n_nationkey == nat_key].n_name.iloc[0],
            "q11_cutoff": float(value.quantile(0.8))}


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------


def q2(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    nat_eu = s["nation"].join(s["region"].filter_sql("r_name = 'EUROPE'"),
                              left_on="n_regionkey", right_on="r_regionkey", how="semi")
    ps_eu = (s["partsupp"]
             .join(s["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
             .join(nat_eu, left_on="s_nationkey", right_on="n_nationkey"))
    minc = ps_eu.groupby("ps_partkey").agg_sql("min(ps_supplycost) as min_cost")
    part = s["part"].filter_sql("p_size = 15 and p_type like '%BRASS'")
    return (ps_eu.join(part, left_on="ps_partkey", right_on="p_partkey")
            .join(minc.rename({"ps_partkey": "mc_partkey"}),
                  left_on="ps_partkey", right_on="mc_partkey")
            .filter_sql("ps_supplycost = min_cost")
            .select(["s_acctbal", "s_name", "n_name", "ps_partkey", "p_mfgr"])
            .collect())


def q6(pkg, ctx, paths, p):
    return (streams(ctx, paths)["lineitem"]
            .filter_sql("l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
                        "and l_discount between 0.05 and 0.07 and l_quantity < 24")
            .agg_sql("sum(l_extendedprice * l_discount) as revenue")
            .collect())


def q8(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    nat_am = s["nation"].join(s["region"].filter_sql("r_name = 'AMERICA'"),
                              left_on="n_regionkey", right_on="r_regionkey", how="semi")
    n2 = s["nation"].rename({"n_name": "supp_nation", "n_nationkey": "n2key"})
    return (s["lineitem"]
            .join(s["part"].filter_sql("p_type = 'ECONOMY ANODIZED STEEL'"),
                  left_on="l_partkey", right_on="p_partkey", how="semi")
            .join(s["orders"].filter_sql(
                "o_orderdate between date '1995-01-01' and date '1996-12-31'"),
                left_on="l_orderkey", right_on="o_orderkey")
            .join(s["customer"], left_on="o_custkey", right_on="c_custkey")
            .join(nat_am, left_on="c_nationkey", right_on="n_nationkey", how="semi")
            .join(s["supplier"], left_on="l_suppkey", right_on="s_suppkey")
            .join(n2.select(["supp_nation", "n2key"]), left_on="s_nationkey", right_on="n2key")
            .with_columns_sql(
                "extract(year from o_orderdate) as o_year, "
                "l_extendedprice * (1 - l_discount) as volume, "
                "case when supp_nation = 'BRAZIL' then l_extendedprice * (1 - l_discount) "
                "else 0.0 end as brazil_volume")
            .groupby("o_year")
            .agg_sql("sum(brazil_volume) / sum(volume) as mkt_share")
            .collect())


def q9(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    return (s["lineitem"]
            .join(s["part"].filter_sql("p_name like '%green%'"),
                  left_on="l_partkey", right_on="p_partkey", how="semi")
            .join(s["partsupp"], left_on=["l_partkey", "l_suppkey"],
                  right_on=["ps_partkey", "ps_suppkey"])
            .join(s["supplier"], left_on="l_suppkey", right_on="s_suppkey")
            .join(s["nation"], left_on="s_nationkey", right_on="n_nationkey")
            .join(s["orders"], left_on="l_orderkey", right_on="o_orderkey")
            .with_columns_sql(
                "extract(year from o_orderdate) as o_year, "
                "l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount")
            .groupby(["n_name", "o_year"])
            .agg_sql("sum(amount) as sum_profit")
            .collect())


def q10(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    return (s["lineitem"]
            .filter_sql("l_returnflag = 'R'")
            .join(s["orders"].filter_sql(
                "o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'"),
                left_on="l_orderkey", right_on="o_orderkey")
            .join(s["customer"], left_on="o_custkey", right_on="c_custkey")
            .join(s["nation"], left_on="c_nationkey", right_on="n_nationkey")
            .groupby(["o_custkey", "c_name", "n_name"])
            .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue")
            .top_k(["revenue"], 20, [True])
            .collect())


def q11(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    return (s["partsupp"]
            .join(s["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
            .join(s["nation"].filter_sql(f"n_name = '{p['q11_nation']}'"),
                  left_on="s_nationkey", right_on="n_nationkey", how="semi")
            .with_columns_sql("ps_supplycost * ps_availqty as value")
            .groupby("ps_partkey")
            .agg_sql("sum(value) as value")
            .filter_sql(f"value > {p['q11_cutoff']}")
            .collect())


def q12(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    return (s["lineitem"]
            .filter_sql("l_shipmode in ('MAIL', 'SHIP') and l_commitdate < l_receiptdate "
                        "and l_shipdate < l_commitdate and l_receiptdate >= date '1994-01-01' "
                        "and l_receiptdate < date '1995-01-01'")
            .join(s["orders"], left_on="l_orderkey", right_on="o_orderkey")
            .groupby("l_shipmode")
            .agg_sql("sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH' "
                     "then 1 else 0 end) as high_line_count, "
                     "sum(case when o_orderpriority <> '1-URGENT' and "
                     "o_orderpriority <> '2-HIGH' then 1 else 0 end) as low_line_count")
            .collect())


def q14(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    return (s["lineitem"]
            .filter_sql("l_shipdate >= date '1995-09-01' and l_shipdate < date '1995-10-01'")
            .join(s["part"], left_on="l_partkey", right_on="p_partkey")
            .agg_sql("100.00 * sum(case when p_type like 'PROMO%' "
                     "then l_extendedprice * (1 - l_discount) else 0 end) / "
                     "sum(l_extendedprice * (1 - l_discount)) as promo_revenue")
            .collect())


def q15(pkg, ctx, paths, p):
    s = streams(ctx, paths)

    def revenue():
        return (streams(ctx, paths)["lineitem"]
                .filter_sql("l_shipdate >= date '1996-01-01' and "
                            "l_shipdate < date '1996-01-01' + interval '3' month")
                .with_columns_sql("l_extendedprice * (1 - l_discount) as v")
                .groupby("l_suppkey")
                .agg_sql("sum(v) as total_revenue"))

    top = float(revenue().agg_sql("max(total_revenue) as m").collect().m[0])
    return (revenue().filter_sql(f"total_revenue >= {top!r}")
            .join(s["supplier"], left_on="l_suppkey", right_on="s_suppkey")
            .select(["l_suppkey", "s_name", "total_revenue"])
            .collect())


def q16(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    sizes = ", ".join(str(x) for x in Q16_SIZES)
    return (s["partsupp"]
            .join(s["supplier"].filter(pkg.col("s_comment").str.contains("Customer Complaints")),
                  left_on="ps_suppkey", right_on="s_suppkey", how="anti")
            .join(s["part"].filter_sql(
                f"p_brand != 'Brand#45' and not (p_type like 'MEDIUM POLISHED%') "
                f"and p_size in ({sizes})"),
                left_on="ps_partkey", right_on="p_partkey")
            .groupby(["p_brand", "p_type", "p_size"])
            .agg_sql("count(distinct ps_suppkey) as supplier_cnt")
            .collect())


def q17(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    li_part = s["lineitem"].join(s["part"].filter_sql("p_brand = 'Brand#23'"),
                                 left_on="l_partkey", right_on="p_partkey", how="semi")
    avg_qty = li_part.groupby("l_partkey").agg_sql("avg(l_quantity) as avg_qty")
    return (li_part
            .join(avg_qty.rename({"l_partkey": "a_partkey"}),
                  left_on="l_partkey", right_on="a_partkey")
            .filter_sql("l_quantity < 0.2 * avg_qty")
            .agg_sql("sum(l_extendedprice) / 7.0 as avg_yearly")
            .collect())


def q18(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    big = (s["lineitem"].groupby("l_orderkey")
           .agg_sql("sum(l_quantity) as sum_qty")
           .filter_sql("sum_qty > 250"))
    return (s["orders"]
            .join(big.rename({"l_orderkey": "b_orderkey"}),
                  left_on="o_orderkey", right_on="b_orderkey")
            .join(s["customer"], left_on="o_custkey", right_on="c_custkey")
            .select(["c_name", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty"])
            .collect())


def q20(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    forest_parts = s["part"].filter_sql("p_name like 'forest%'")
    shipped = (s["lineitem"]
               .filter_sql("l_shipdate >= date '1994-01-01' and "
                           "l_shipdate < date '1994-01-01' + interval '1' year")
               .groupby(["l_partkey", "l_suppkey"])
               .agg_sql("sum(l_quantity) as qty"))
    excess = (s["partsupp"]
              .join(forest_parts, left_on="ps_partkey", right_on="p_partkey", how="semi")
              .join(shipped, left_on=["ps_partkey", "ps_suppkey"],
                    right_on=["l_partkey", "l_suppkey"])
              .filter_sql("ps_availqty > 0.5 * qty"))
    return (s["supplier"]
            .join(s["nation"].filter_sql("n_name = 'CANADA'"),
                  left_on="s_nationkey", right_on="n_nationkey", how="semi")
            .join(excess, left_on="s_suppkey", right_on="ps_suppkey", how="semi")
            .select(["s_name", "s_address"])
            .collect())


def q22(pkg, ctx, paths, p):
    s = streams(ctx, paths)
    in_list = ", ".join(f"'{c}'" for c in Q22_CODES)

    def cust():
        return (streams(ctx, paths)["customer"]
                .with_columns_sql("substring(c_phone, 1, 2) as cntrycode")
                .filter_sql(f"cntrycode in ({in_list})"))

    avg_bal = float(cust().filter_sql("c_acctbal > 0.0")
                    .agg_sql("avg(c_acctbal) as a").collect().a[0])
    return (cust().filter_sql(f"c_acctbal > {avg_bal!r}")
            .join(s["orders"], left_on="c_custkey", right_on="o_custkey", how="anti")
            .groupby("cntrycode")
            .agg_sql("count(*) as numcust, sum(c_acctbal) as totacctbal")
            .collect())


# ---------------------------------------------------------------------------
# pandas oracles (tests/test_tpch.py's and tests/test_tpch2.py's)
# ---------------------------------------------------------------------------


def pandas_q2(dfs, p):
    n, r, su, ps, pt = (dfs[k] for k in ("nation", "region", "supplier", "partsupp", "part"))
    eu = n.merge(r[r.r_name == "EUROPE"], left_on="n_regionkey", right_on="r_regionkey")
    pse = ps.merge(su, left_on="ps_suppkey", right_on="s_suppkey").merge(
        eu, left_on="s_nationkey", right_on="n_nationkey")
    mc = pse.groupby("ps_partkey").ps_supplycost.min().reset_index(name="min_cost")
    pf = pt[(pt.p_size == 15) & pt.p_type.str.endswith("BRASS")]
    exp = pse.merge(pf, left_on="ps_partkey", right_on="p_partkey").merge(mc, on="ps_partkey")
    return exp[exp.ps_supplycost == exp.min_cost][
        ["s_acctbal", "s_name", "n_name", "ps_partkey", "p_mfgr"]]


def pandas_q6(dfs, p):
    l = dfs["lineitem"]
    f = l[(l.l_shipdate >= datetime.date(1994, 1, 1)) & (l.l_shipdate < datetime.date(1995, 1, 1))
          & (l.l_discount >= 0.05) & (l.l_discount <= 0.07) & (l.l_quantity < 24)]
    return pd.DataFrame({"revenue": [(f.l_extendedprice * f.l_discount).sum()]})


def pandas_q8(dfs, p):
    l, pt, o, c, su, n, r = (dfs[k] for k in ("lineitem", "part", "orders", "customer",
                                              "supplier", "nation", "region"))
    am_keys = n.merge(r[r.r_name == "AMERICA"], left_on="n_regionkey",
                      right_on="r_regionkey").n_nationkey
    f = l[l.l_partkey.isin(pt[pt.p_type == "ECONOMY ANODIZED STEEL"].p_partkey)]
    j = (f.merge(o[(o.o_orderdate >= datetime.date(1995, 1, 1))
                   & (o.o_orderdate <= datetime.date(1996, 12, 31))],
                 left_on="l_orderkey", right_on="o_orderkey")
         .merge(c[c.c_nationkey.isin(am_keys)], left_on="o_custkey", right_on="c_custkey")
         .merge(su, left_on="l_suppkey", right_on="s_suppkey")
         .merge(n.rename(columns={"n_name": "supp_nation"}),
                left_on="s_nationkey", right_on="n_nationkey"))
    j = j.assign(o_year=pd.to_datetime(j.o_orderdate).dt.year,
                 volume=j.l_extendedprice * (1 - j.l_discount))
    j["brazil_volume"] = np.where(j.supp_nation == "BRAZIL", j.volume, 0.0)
    g = j.groupby("o_year").agg(bv=("brazil_volume", "sum"), v=("volume", "sum"))
    return (g.bv / g.v).reset_index(name="mkt_share")


def pandas_q9(dfs, p):
    l, pt, ps, su, n, o = (dfs[k] for k in ("lineitem", "part", "partsupp", "supplier",
                                            "nation", "orders"))
    j = (l[l.l_partkey.isin(pt[pt.p_name.str.contains("green")].p_partkey)]
         .merge(ps, left_on=["l_partkey", "l_suppkey"], right_on=["ps_partkey", "ps_suppkey"])
         .merge(su, left_on="l_suppkey", right_on="s_suppkey")
         .merge(n, left_on="s_nationkey", right_on="n_nationkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey"))
    j = j.assign(o_year=pd.to_datetime(j.o_orderdate).dt.year,
                 amount=j.l_extendedprice * (1 - j.l_discount) - j.ps_supplycost * j.l_quantity)
    return j.groupby(["n_name", "o_year"]).amount.sum().reset_index(name="sum_profit")


def pandas_q10(dfs, p):
    l, o, c, n = dfs["lineitem"], dfs["orders"], dfs["customer"], dfs["nation"]
    of = o[(o.o_orderdate >= datetime.date(1993, 10, 1))
           & (o.o_orderdate < datetime.date(1994, 1, 1))]
    m = (l[l.l_returnflag == "R"]
         .merge(of, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n, left_on="c_nationkey", right_on="n_nationkey"))
    m["rev"] = m.l_extendedprice * (1 - m.l_discount)
    return (m.groupby(["o_custkey", "c_name", "n_name"]).rev.sum()
            .reset_index(name="revenue").nlargest(20, "revenue"))


def pandas_q11(dfs, p):
    ps, su, n = dfs["partsupp"], dfs["supplier"], dfs["nation"]
    nat_key = int(n[n.n_name == p["q11_nation"]].n_nationkey.iloc[0])
    j = ps[ps.ps_suppkey.isin(su[su.s_nationkey == nat_key].s_suppkey)]
    j = j.assign(value=j.ps_supplycost * j.ps_availqty)
    g = j.groupby("ps_partkey").value.sum().reset_index()
    return g[g.value > p["q11_cutoff"]]


def pandas_q12(dfs, p):
    l, o = dfs["lineitem"], dfs["orders"]
    f = l[l.l_shipmode.isin(["MAIL", "SHIP"]) & (l.l_commitdate < l.l_receiptdate)
          & (l.l_shipdate < l.l_commitdate) & (l.l_receiptdate >= datetime.date(1994, 1, 1))
          & (l.l_receiptdate < datetime.date(1995, 1, 1))]
    m = f.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    hi = m.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    return (pd.DataFrame({"l_shipmode": m.l_shipmode, "high": hi.astype(int),
                          "low": (~hi).astype(int)})
            .groupby("l_shipmode")
            .agg(high_line_count=("high", "sum"), low_line_count=("low", "sum"))
            .reset_index())


def pandas_q14(dfs, p):
    l, pt = dfs["lineitem"], dfs["part"]
    f = l[(l.l_shipdate >= datetime.date(1995, 9, 1)) & (l.l_shipdate < datetime.date(1995, 10, 1))]
    m = f.merge(pt, left_on="l_partkey", right_on="p_partkey")
    rev = m.l_extendedprice * (1 - m.l_discount)
    promo = rev.where(m.p_type.str.startswith("PROMO"), 0.0)
    return pd.DataFrame({"promo_revenue": [100.0 * promo.sum() / rev.sum()]})


def pandas_q15(dfs, p):
    l, su = dfs["lineitem"], dfs["supplier"]
    f = l[(l.l_shipdate >= datetime.date(1996, 1, 1)) & (l.l_shipdate < datetime.date(1996, 4, 1))]
    g = (f.l_extendedprice * (1 - f.l_discount)).groupby(f.l_suppkey).sum().rename(
        "total_revenue")
    win = g[g == g.max()].reset_index()
    return win.merge(su, left_on="l_suppkey", right_on="s_suppkey")[
        ["l_suppkey", "s_name", "total_revenue"]]


def pandas_q16(dfs, p):
    ps, su, pt = dfs["partsupp"], dfs["supplier"], dfs["part"]
    bad = su[su.s_comment.str.contains("Customer Complaints")].s_suppkey
    pf = pt[(pt.p_brand != "Brand#45") & ~pt.p_type.str.startswith("MEDIUM POLISHED")
            & pt.p_size.isin(list(Q16_SIZES))]
    j = ps[~ps.ps_suppkey.isin(bad)].merge(pf, left_on="ps_partkey", right_on="p_partkey")
    return (j.groupby(["p_brand", "p_type", "p_size"]).ps_suppkey.nunique()
            .reset_index(name="supplier_cnt"))


def pandas_q17(dfs, p):
    l, pt = dfs["lineitem"], dfs["part"]
    f = l[l.l_partkey.isin(pt[pt.p_brand == "Brand#23"].p_partkey)]
    a = f.groupby("l_partkey").l_quantity.mean().rename("avg_qty")
    j = f.merge(a, on="l_partkey")
    sel = j[j.l_quantity < 0.2 * j.avg_qty]
    return pd.DataFrame({"avg_yearly": [sel.l_extendedprice.sum() / 7.0]})


def pandas_q18(dfs, p):
    l, o, c = dfs["lineitem"], dfs["orders"], dfs["customer"]
    g = l.groupby("l_orderkey").l_quantity.sum()
    keys = g[g > 250]
    return (o[o.o_orderkey.isin(keys.index)]
            .merge(keys.reset_index(name="sum_qty"), left_on="o_orderkey", right_on="l_orderkey")
            .merge(c, left_on="o_custkey", right_on="c_custkey")
            )[["c_name", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty"]]


def pandas_q20(dfs, p):
    pt, l, ps, su, n = (dfs[k] for k in ("part", "lineitem", "partsupp", "supplier", "nation"))
    fp = pt[pt.p_name.str.startswith("forest")].p_partkey
    f = l[(l.l_shipdate >= datetime.date(1994, 1, 1)) & (l.l_shipdate < datetime.date(1995, 1, 1))]
    sq = f.groupby(["l_partkey", "l_suppkey"]).l_quantity.sum().reset_index(name="qty")
    ex = ps[ps.ps_partkey.isin(fp)].merge(
        sq, left_on=["ps_partkey", "ps_suppkey"], right_on=["l_partkey", "l_suppkey"])
    ex = ex[ex.ps_availqty > 0.5 * ex.qty]
    ca = n[n.n_name == "CANADA"].n_nationkey
    return su[su.s_nationkey.isin(ca) & su.s_suppkey.isin(ex.ps_suppkey)][["s_name", "s_address"]]


def pandas_q22(dfs, p):
    c, o = dfs["customer"], dfs["orders"]
    cc = c.assign(cntrycode=c.c_phone.str[:2])
    cf = cc[cc.cntrycode.isin(Q22_CODES)]
    avg = cf[cf.c_acctbal > 0].c_acctbal.mean()
    sel = cf[(cf.c_acctbal > avg) & ~cf.c_custkey.isin(o.o_custkey)]
    return sel.groupby("cntrycode").agg(numcust=("c_custkey", "size"),
                                        totacctbal=("c_acctbal", "sum")).reset_index()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def same_sorted(by):
    """Both results hold the same rows, at least one: the expected columns,
    sorted on the keys ``by``; floats to rtol 1e-9, the rest exact."""
    def check(got, exp):
        assert len(exp) > 0
        got = got.sort_values(by, na_position="last").reset_index(drop=True)[list(exp.columns)]
        exp = exp.sort_values(by, na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=1e-9)
    return check


def same_scalar(column):
    def check(got, exp):
        assert len(got) == len(exp) == 1
        np.testing.assert_allclose(float(got[column][0]), float(exp[column][0]), rtol=1e-9)
    return check


def same_top(got, exp):
    """Q10's top 20 by revenue: the same revenues in order, and the same
    customers (no tie at this data's boundary)."""
    assert len(exp) > 0 and len(got) == len(exp)
    got = got.sort_values(["revenue", "o_custkey"], ascending=[False, True])
    exp = exp.sort_values(["revenue", "o_custkey"], ascending=[False, True])
    np.testing.assert_allclose(got.revenue.to_numpy(), exp.revenue.to_numpy(), rtol=1e-9)
    assert got.o_custkey.tolist() == exp.o_custkey.tolist()
    assert got.c_name.tolist() == exp.c_name.tolist()


# name -> (query, pandas oracle, comparison)
QUERIES = {
    "q2": (q2, pandas_q2, same_sorted(["ps_partkey", "s_name"])),
    "q6": (q6, pandas_q6, same_scalar("revenue")),
    "q8": (q8, pandas_q8, same_sorted(["o_year"])),
    "q9": (q9, pandas_q9, same_sorted(["n_name", "o_year"])),
    "q10": (q10, pandas_q10, same_top),
    "q11": (q11, pandas_q11, same_sorted(["ps_partkey"])),
    "q12": (q12, pandas_q12, same_sorted(["l_shipmode"])),
    "q14": (q14, pandas_q14, same_scalar("promo_revenue")),
    "q15": (q15, pandas_q15, same_sorted(["l_suppkey"])),
    "q16": (q16, pandas_q16, same_sorted(["p_brand", "p_type", "p_size"])),
    "q17": (q17, pandas_q17, same_scalar("avg_yearly")),
    "q18": (q18, pandas_q18, same_sorted(["o_orderkey"])),
    "q20": (q20, pandas_q20, same_sorted(["s_name"])),
    "q22": (q22, pandas_q22, same_sorted(["cntrycode"])),
}


# ---------------------------------------------------------------------------
# the test harness shared by tests/test_torch_tpch_*.py
# ---------------------------------------------------------------------------

# the data a case runs on: tpch_data.generate's arguments at sf 0.003 (on
# the skewed null data, seed 37 is one at which every query selects rows;
# Q2's, Q8's and Q20's filters select none at some seeds of this size)
DATA = {"uniform": {"seed": 11}, "skew": {"seed": 11, "skew": True},
        "nulls": {"seed": 37, "skew": True, "nulls": True}}
STRATEGIES = ["hashtable", "sort"]
# the default broadcast threshold (every build side is broadcast at this
# size) and 100 rows (the larger builds become hash-partitioned joins)
THRESHOLDS = {"broadcast": None, "partitioned": 100}


def make_env(data, tmp_path_factory):
    """(data name, Parquet paths, pandas frames, query constants)."""
    import tpch_data

    tables = tpch_data.generate(sf=0.003, **DATA[data])
    paths = tpch_data.write_parquet_dir(tables, str(tmp_path_factory.mktemp(f"tpch_{data}")))
    dfs = {k: t.to_pandas() for k, t in tables.items()}
    return data, paths, dfs, params(dfs)


def run_case(env, query, layout, join_build, monkeypatch, reference_cache):
    """Run ``query`` through the port on the CPU under the strategy and
    layout given, with no batch leaving the fused kernels
    (``fuse.FALLBACKS``) or taking the per-step stage path
    (``stagefuse.SEQUENTIAL``), and hold it to the reference (x64) and,
    but on null data, where pandas is not null-safe, to pandas.  The
    reference's answer is computed once per (query, data, layout)."""
    import quokka_tpu
    import quokka_tpu.optimizer as ref_optimizer
    import quokka_tpu_torch
    import quokka_tpu_torch.optimizer as port_optimizer
    from quokka_tpu_torch.ops import fuse, stagefuse, strategy

    data, paths, dfs, p = env
    build, oracle, same = QUERIES[query]
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    threshold = THRESHOLDS[layout]
    if threshold is not None:
        monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", threshold)
        monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", threshold)
    strategy.reset_used()
    fallbacks, sequential = fuse.FALLBACKS, stagefuse.SEQUENTIAL
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = build(quokka_tpu_torch, ctx, paths, p)
    assert fuse.FALLBACKS == fallbacks, f"{query} left the fused kernels"
    assert stagefuse.SEQUENTIAL == sequential, f"{query} took the per-step stage path"
    key = (query, data, layout)
    if key not in reference_cache:
        reference_cache[key] = build(
            quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2), paths, p)
    same(got, reference_cache[key])
    if data != "nulls":
        same(got, oracle(dfs, p))
