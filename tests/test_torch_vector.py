"""The PyTorch port's vector, linear-algebra and quantile tier against the
reference (quokka_tpu, JAX x64 on the CPU): nearest_neighbors and its
vector_nn_join alias, gramian, covariance, approximate_quantile, the IVF
sidecar index and the ANN pushdown, and the plain versions of K21
(``ops/vector.py``) and K22 (``ops/linalg.py``) against the reference's
``_sims`` + ``lax.top_k`` and ``_accumulate``.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances: ids and row sets exact; similarity scores atol 1e-6 (both
float32 dot products, summed in another order); the Gramian rtol 1e-4 and
the covariance rtol 1e-3, atol 1e-4 against the reference (the reference
tests' own tolerances: the reference sums in float32), and rtol 1e-9
against a float64 oracle on the float32-cast columns (the port sums exact
float32 products in float64); k-means centroids rtol 1e-5 (and atol 1e-6
against a float64 oracle); quantiles atol 0.02 against np.quantile
(tests/test_extras.py's tolerance).
"""

import shutil

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import quokka_tpu
import quokka_tpu_torch
from quokka_tpu.dataset import vector as ref_vector
from quokka_tpu.dataset.readers import InputArrowDataset as RefArrowDataset
from quokka_tpu.executors.linalg import GramianExecutor as RefGramian
from quokka_tpu.executors.vector import NearestNeighborExecutor as RefNN
from quokka_tpu_torch.dataset import vector as port_vector
from quokka_tpu_torch.dataset.readers import InputArrowDataset as PortArrowDataset
from quokka_tpu_torch.ops import linalg, vector
from quokka_tpu_torch.ops.batch import VecCol

from torch_port_util import port_batch, ref_batch_of


def _ctxs(exec_channels=2):
    return (quokka_tpu.QuokkaContext(exec_channels=exec_channels),
            quokka_tpu_torch.QuokkaContext(exec_channels=exec_channels, device="cpu"))


def _vec_table(vecs, null_rows=(), extra=None):
    n, d = vecs.shape
    mask = np.zeros(n, dtype=bool)
    mask[list(null_rows)] = True
    flat = pa.array(vecs.astype(np.float32).reshape(-1))
    emb = pa.FixedSizeListArray.from_arrays(flat, d, mask=pa.array(mask)) if len(null_rows) \
        else pa.FixedSizeListArray.from_arrays(flat, d)
    cols = {"id": np.arange(n, dtype=np.int64), "emb": emb}
    cols.update(extra or {})
    return pa.table(cols)


def _by_query(df):
    """Per query, the (id, score) pairs sorted by id."""
    out = {}
    for q, g in df.groupby("query_idx"):
        g = g.sort_values("id")
        out[int(q)] = (g.id.to_numpy(), g.score.to_numpy())
    return out


def _same_results(got, exp):
    assert list(got.columns) == list(exp.columns)
    assert got.query_idx.tolist() == exp.query_idx.tolist()
    g, e = _by_query(got), _by_query(exp)
    assert g.keys() == e.keys()
    for q in e:
        np.testing.assert_array_equal(g[q][0], e[q][0], err_msg=f"query {q}")
        np.testing.assert_allclose(g[q][1], e[q][1], rtol=0, atol=1e-6, err_msg=f"query {q}")


def _run_nn(ctx, reader_cls, table, queries, k, batch_rows, **kw):
    src = ctx.read_dataset(reader_cls(table, batch_rows=batch_rows)) if batch_rows \
        else ctx.from_arrow(table)
    return src.nearest_neighbors(queries, "emb", k, **kw).collect()


# ---------------------------------------------------------------------------
# nearest_neighbors end to end
# ---------------------------------------------------------------------------

# tests/test_extras.py's two shapes: (rows, dim, queries, k, batch rows, seed)
NN_SHAPES = {"one_batch": (2000, 32, 4, 5, None, 5), "multi_batch": (3000, 16, 2, 3, 256, 6)}


@pytest.mark.parametrize("shape", list(NN_SHAPES))
def test_nearest_neighbors_matches_reference(shape):
    n, d, nq, k, batch_rows, seed = NN_SHAPES[shape]
    r = np.random.default_rng(seed)
    vecs = r.normal(size=(n, d)).astype(np.float32)
    queries = r.normal(size=(nq, d)).astype(np.float32)
    t = _vec_table(vecs)
    ref, port = _ctxs()
    got = _run_nn(port, PortArrowDataset, t, queries, k, batch_rows)
    exp = _run_nn(ref, RefArrowDataset, t, queries, k, batch_rows)
    _same_results(got, exp)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    sims = qn @ vn.T
    for qi in range(nq):
        assert set(got[got.query_idx == qi].id) == set(np.argsort(-sims[qi])[:k])


def test_nearest_neighbors_with_payload_and_alias():
    r = np.random.default_rng(9)
    n, d = 1500, 8
    vecs = r.normal(size=(n, d)).astype(np.float32)
    queries = r.normal(size=(3, d)).astype(np.float32)
    tags = np.array(["red", "green", "blue"], dtype=object)[r.integers(0, 3, n)]
    t = _vec_table(vecs, extra={"tag": pa.array(tags, type=pa.string()),
                                "w": r.normal(size=n)})
    ref, port = _ctxs()
    for pkg_ctx, reader in ((port, PortArrowDataset), (ref, RefArrowDataset)):
        src = pkg_ctx.read_dataset(reader(t, batch_rows=512))
        a = src.nearest_neighbors(queries, "emb", 4, payload=["id", "tag"]).collect()
        b = src.vector_nn_join(queries, "emb", 4, payload=["id", "tag"]).collect()
        assert list(a.columns) == ["query_idx", "score", "id", "tag"]
        assert a.equals(b)
        if pkg_ctx is port:
            got = a
        else:
            exp = a
    _same_results(got, exp)
    assert got.tag.tolist() == exp.tag.tolist()
    assert got.tag.tolist() == tags[got.id.to_numpy()].tolist()


def test_batch_rows_below_k_drops_the_minus_inf_slots():
    """Batches of 4 live rows under k = 10: each batch's top k holds invalid
    (-inf) rows, which never reach the output."""
    r = np.random.default_rng(12)
    vecs = r.normal(size=(23, 6)).astype(np.float32)
    queries = r.normal(size=(3, 6)).astype(np.float32)
    t = _vec_table(vecs)
    ref, port = _ctxs()
    got = _run_nn(port, PortArrowDataset, t, queries, 10, 4)
    exp = _run_nn(ref, RefArrowDataset, t, queries, 10, 4)
    _same_results(got, exp)
    assert len(got) == 30 and np.isfinite(got.score).all()


@pytest.mark.parametrize("batch_rows", [None, 8], ids=["one_batch", "batches_of_8"])
def test_null_and_nan_vectors(batch_rows):
    """Null rows are zero vectors (score 0); a NaN vector scores NaN, which
    lax.top_k ranks first within a batch and the running merge last, as in
    the reference."""
    r = np.random.default_rng(13)
    vecs = r.normal(size=(40, 5)).astype(np.float32)
    vecs[7] = np.nan
    vecs[21, 2] = np.nan
    queries = r.normal(size=(2, 5)).astype(np.float32)
    t = _vec_table(vecs, null_rows=(3, 30, 31))
    ref, port = _ctxs()
    got = _run_nn(port, PortArrowDataset, t, queries, 6, batch_rows)
    exp = _run_nn(ref, RefArrowDataset, t, queries, 6, batch_rows)
    g, e = _by_query(got), _by_query(exp)
    assert g.keys() == e.keys()
    for q in e:
        np.testing.assert_array_equal(g[q][0], e[q][0])
        np.testing.assert_allclose(g[q][1], e[q][1], rtol=0, atol=1e-6)
    if batch_rows is None:
        assert np.isnan(got.score).sum() == 4  # both NaN rows, for both queries


# ---------------------------------------------------------------------------
# K21's plain version against the reference's _sims + lax.top_k
# ---------------------------------------------------------------------------


def test_k21_batch_order_is_lax_top_k_order():
    """Ties (duplicate rows, null rows scoring 0), a NaN row, invalid rows
    and the padding: the plain version's batch top-k equals lax.top_k over
    the reference's scores, row for row."""
    r = np.random.default_rng(21)
    vecs = r.normal(size=(60, 7)).astype(np.float32)
    vecs[10] = vecs[40]  # an exact tie: the lower row first
    vecs[25] = np.nan
    t = _vec_table(vecs, null_rows=(5, 6, 50))
    rb = ref_batch_of(t)
    valid = np.asarray(rb.valid).copy()
    valid[[12, 40, 59]] = False
    queries = vector.normalize_queries(r.normal(size=(4, 7)))
    n = valid.shape[0]
    sims = RefNN._sims(jax.numpy.asarray(queries),
                       jax.numpy.asarray(np.asarray(rb.columns["emb"].data, np.float32)),
                       jax.numpy.asarray(valid))
    exp_s, exp_i = jax.lax.top_k(sims, n)
    pb = port_batch(rb)
    assert isinstance(pb.columns["emb"], VecCol)
    got_s, got_i = vector.batch_topk_plain(torch.from_numpy(queries), pb.columns["emb"].data,
                                           torch.from_numpy(valid), n)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(exp_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(exp_s), rtol=0, atol=1e-6)
    assert torch.isnan(got_s[:, 0]).all()  # the NaN row ranks first


def test_k21_merge_keeps_the_reference_host_merge_order():
    """Two batches merged into the running state equal the reference's
    argsort(-scores) merge of the two batches' top k."""
    r = np.random.default_rng(22)
    q = torch.from_numpy(vector.normalize_queries(r.normal(size=(3, 4))))
    k = 5
    s, h = vector.empty_state(3, k, "cpu")
    per_batch = []
    for b in range(2):
        v = torch.from_numpy(r.normal(size=(256, 4)))
        valid = torch.ones(256, dtype=torch.bool)
        s, h = vector.sims_topk_plain(q, v, valid, k, s, h, b)
        per_batch.append(vector.batch_topk_plain(q, v, valid, k))
    ms = np.concatenate([per_batch[0][0].numpy(), per_batch[1][0].numpy()], 1)
    mh = np.concatenate([per_batch[0][1].numpy(), (1 << 32) | per_batch[1][1].numpy()], 1)
    order = np.argsort(-ms, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(s.numpy(), np.take_along_axis(ms, order, 1))
    np.testing.assert_array_equal(h.numpy(), np.take_along_axis(mh, order, 1))


# ---------------------------------------------------------------------------
# gramian / covariance (K22) and approximate_quantile
# ---------------------------------------------------------------------------


def _numeric_table(kind, n=1200, seed=31):
    r = np.random.default_rng(seed)
    v = r.normal(size=n) * 3 + 1
    q = r.integers(1, 50, n)
    w = r.uniform(0, 2, n)
    if kind == "int_nulls":
        nm = np.zeros(n, dtype=bool)
        nm[[17, 400]] = True  # the int sentinel, cast to float32, as in the reference
        return pa.table({"v": v, "q": pa.array(np.where(nm, 0, q), mask=nm), "w": w})
    nm = r.random(n) < 0.01
    return pa.table({"v": pa.array(v, mask=nm), "q": q, "w": w})


def _f32_oracle(columns, valid):
    m = np.stack([c.astype(np.float32) for c in columns], 1).astype(np.float64)
    m[~valid] = 0.0
    return m.T @ m, m.sum(0), int(valid.sum())


@pytest.mark.parametrize("kind", ["int_nulls", "float_nulls"])
@pytest.mark.parametrize("covariance", [False, True], ids=["gramian", "covariance"])
def test_gramian_and_covariance(kind, covariance):
    t = _numeric_table(kind)
    cols = ["v", "q", "w"]
    ref, port = _ctxs()

    def run(ctx):
        s = ctx.from_arrow(t).filter_sql("w < 1.8")
        s = s.covariance(cols) if covariance else s.gramian(cols)
        return s.collect().set_index("column").loc[cols, cols].to_numpy()

    got, exp = run(port), run(ref)
    if covariance:
        np.testing.assert_allclose(got, exp, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-4)
    # the float64 oracle over the same float32-cast values (ints: the null
    # sentinel, floats: NaN)
    pdf = t.to_pandas()
    raw = {"v": pdf.v.to_numpy(np.float64), "w": pdf.w.to_numpy(np.float64)}
    raw["q"] = pdf.q.fillna(-(2**63)).to_numpy().astype(np.int64) if kind == "int_nulls" \
        else pdf.q.to_numpy(np.int64)
    keep = raw["w"] < 1.8
    g, sums, n = _f32_oracle([raw[c] for c in cols], keep)
    if covariance:
        mu = sums / n
        g = g / n - np.outer(mu, mu)
    np.testing.assert_allclose(got, g, rtol=1e-9)


def _k22_plain_against_reference(columns, valid):
    """K22's plain version against the reference's ``_accumulate`` (float32
    sums: rtol 1e-4) and the float64 oracle (rtol 1e-9)."""
    mat = np.stack(columns, 1)
    g_ref, s_ref = RefGramian._accumulate(jax.numpy.asarray(mat.astype(np.float32)),
                                          jax.numpy.asarray(valid))
    g, s = linalg.gramian_plain([torch.from_numpy(c) for c in columns], torch.from_numpy(valid))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref, np.float64), rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref, np.float64), rtol=1e-4, atol=1e-3)
    go, so, _ = _f32_oracle(columns, valid)
    np.testing.assert_allclose(g.numpy(), go, rtol=1e-9)
    np.testing.assert_allclose(s.numpy(), so, rtol=1e-9)


def test_k22_plain_matches_reference_accumulate():
    t = _numeric_table("float_nulls", n=3000, seed=32)
    rb = ref_batch_of(t)
    valid = np.asarray(rb.valid).copy()
    valid[::7] = False
    cols = ["v", "q", "w"]
    mat = np.stack([np.asarray(rb.columns[c].data) for c in cols], 1)
    g_ref, s_ref = RefGramian._accumulate(jax.numpy.asarray(mat.astype(np.float32)),
                                          jax.numpy.asarray(valid))
    pb = port_batch(rb)
    g, s = linalg.gramian_plain([pb.columns[c].data for c in cols], torch.from_numpy(valid))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref, np.float64), rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref, np.float64), rtol=1e-4, atol=1e-3)
    go, so, _ = _f32_oracle([np.asarray(rb.columns[c].data) for c in cols], valid)
    np.testing.assert_allclose(g.numpy(), go, rtol=1e-9)
    np.testing.assert_allclose(s.numpy(), so, rtol=1e-9)


@pytest.mark.parametrize("d", [1, 8, 9])
def test_k22_plain_matches_reference_accumulate_at_the_register_path_ends(d):
    # the card holds K22's register path (d <= 8) and its shared-memory path
    # (d > 8) against this plain version
    r = np.random.default_rng(33 + d)
    n = 3000
    columns = []
    for j in range(d):
        if j % 3 == 0:
            x = r.normal(size=n) * 3 + 1
            if j > 0:  # a null float in a later column
                x[r.random(n) < 0.01] = np.nan
        elif j % 3 == 1:
            x = r.integers(1, 50, n)
        else:
            x = r.uniform(0, 2, n)
        columns.append(x)
    _k22_plain_against_reference(columns, r.random(n) < 0.9)


@pytest.mark.parametrize("n", [1, 127, (1 << 20) + 5])
@pytest.mark.parametrize("nq", [1, 4, 10_000])
def test_k21_plan_covers_every_row_once(nq, n):
    for slots in (132, 264, 1):  # an H100's SMs at one and two blocks each; one slot
        n_split, per = vector._plan(nq, n, slots)
        assert 1 <= n_split <= vector._MAX_SPLIT
        assert per % vector._TN == 0
        bounds = [(s * per, min(n, (s + 1) * per)) for s in range(n_split)]
        assert all(lo < hi for lo, hi in bounds)  # every split holds rows
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if nq == 10_000 and n > 1 << 20:
        # the vector path's shape fills whole waves: the busiest of 264
        # slots takes within 2% of the mean's tiles
        n_split, per = vector._plan(nq, n, 264)
        q_tiles, tiles = -(-nq // vector._TQ), -(-n // vector._TN)
        waves = -(-q_tiles * n_split // 264)
        assert waves * per // vector._TN <= 1.02 * q_tiles * tiles / 264


def test_approximate_quantile_matches_reference():
    r = np.random.default_rng(41)
    x = np.concatenate([r.normal(size=20000), r.exponential(2, 20000)])
    t = pa.table({"v": x})
    ref, port = _ctxs()
    qs = [0.01, 0.25, 0.5, 0.75, 0.99]
    got = port.from_arrow(t).approximate_quantile("v", qs).collect().sort_values("quantile")
    exp = ref.from_arrow(t).approximate_quantile("v", qs).collect().sort_values("quantile")
    assert got["quantile"].tolist() == exp["quantile"].tolist()
    np.testing.assert_allclose(got.v.to_numpy(), exp.v.to_numpy(), rtol=1e-12)


@pytest.mark.parametrize("exec_channels", [1, 4])
def test_quantile_partition_independent(exec_channels):
    r = np.random.default_rng(4)
    x = r.normal(size=30000)
    port = quokka_tpu_torch.QuokkaContext(exec_channels=exec_channels, device="cpu")
    got = port.read_dataset(PortArrowDataset(pa.table({"v": x}), batch_rows=4096)) \
        .approximate_quantile("v", [0.25, 0.5, 0.75]).collect().sort_values("quantile")
    np.testing.assert_allclose(got.v.to_numpy(), np.quantile(x, [0.25, 0.5, 0.75]), atol=0.02)


# ---------------------------------------------------------------------------
# the IVF sidecar and the ANN pushdown
# ---------------------------------------------------------------------------


def _clustered_parquet(tmp_path, name, n=8000, dim=16, seed=0, row_group=512):
    """tests/test_cloud_readers.py's clustered vectors: 8 centres, each
    vector a centre plus normal noise of 0.3."""
    r = np.random.default_rng(seed)
    centers = r.normal(size=(8, dim)) * 5
    vecs = centers[r.integers(0, 8, n)] + r.normal(size=(n, dim)) * 0.3
    path = str(tmp_path / name)
    pq.write_table(_vec_table(vecs).rename_columns(["id", "vec"]), path,
                   row_group_size=row_group)
    return path, centers, r


def _lloyd_f64(vecs, n_cells, iters, seed=0):
    """The sidecar's k-means in float64 numpy: the same initial cells and
    Lloyd iterations.  Returns the centroids, the last assignment and the
    least gap between a vector's best and second-best cell score over all
    iterations."""
    x = vecs.astype(np.float64)
    cents = x[np.random.default_rng(seed).choice(len(x), n_cells, replace=False)].copy()
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    gap = np.inf
    for _ in range(iters):
        cn = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-9)
        s = xn @ cn.T
        top2 = np.sort(s, axis=1)[:, -2:]
        gap = min(gap, float((top2[:, 1] - top2[:, 0]).min()))
        a = s.argmax(axis=1)
        for j in range(n_cells):
            if (a == j).any():
                cents[j] = x[a == j].mean(axis=0)
    return cents, a, gap


def test_vector_index_matches_reference(tmp_path):
    """The port's k-means equals a float64 oracle and the reference's:
    centroids, cells per row group and the pruned row groups.  Both packages
    assign by a float32 argmax of cosine scores, summed in different orders,
    so the comparison holds only where every vector's best cell leads its
    second by far more than float32 rounding: the data is built so, and the
    test asserts that gap.  Eight tight clusters in runs of rows (so row
    groups hold few cells), one initial cell drawn from each: the initial
    rows are the ones ``default_rng(0).choice`` picks."""
    n, dim, n_cells = 8000, 16, 8
    r = np.random.default_rng(0)
    centers = r.normal(size=(n_cells, dim)) * 5
    labels = np.repeat(np.arange(n_cells), n // n_cells)
    labels[np.random.default_rng(0).choice(n, n_cells, replace=False)] = np.arange(n_cells)
    vecs = (centers[labels] + r.normal(size=(n, dim)) * 0.3).astype(np.float32)
    path = str(tmp_path / "vecs.parquet")
    pq.write_table(_vec_table(vecs).rename_columns(["id", "vec"]), path, row_group_size=512)
    ref_path = str(tmp_path / "ref.parquet")
    shutil.copy(path, ref_path)
    cents64, assign64, gap = _lloyd_f64(vecs, n_cells, iters=5)
    assert gap > 1e-2, gap  # float32 scores of unit vectors at d = 16 err ~1e-6
    ref_vector.build_vector_index(ref_path, "vec", n_cells=n_cells, iters=5)
    port_vector.build_vector_index(path, "vec", n_cells=n_cells, iters=5, device="cpu")
    a = np.load(port_vector.sidecar_path(path))
    b = np.load(ref_vector.sidecar_path(ref_path))
    np.testing.assert_allclose(a["centroids"], cents64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=1e-5)
    rg_cells = np.zeros_like(a["rg_cells"])
    for g in range(len(rg_cells)):
        rg_cells[g, np.unique(assign64[g * 512:(g + 1) * 512])] = True
    np.testing.assert_array_equal(a["rg_cells"], rg_cells)
    np.testing.assert_array_equal(a["rg_cells"], b["rg_cells"])
    assert a["vec_col"].tolist() == b["vec_col"].tolist() == ["vec"]
    queries = centers[:3] + r.normal(size=(3, dim)) * 0.1
    for nprobe in (1, 2, 4):
        np.testing.assert_array_equal(port_vector.prune_row_groups(path, queries, nprobe),
                                      ref_vector.prune_row_groups(ref_path, queries, nprobe))


def test_port_reads_the_reference_sidecar(tmp_path):
    """A sidecar written by the reference prunes the same row groups in the
    port, and the approximate query over it returns the reference's rows."""
    path, centers, r = _clustered_parquet(tmp_path, "vecs.parquet")
    ref_vector.build_vector_index(path, "vec", n_cells=16, iters=5)
    queries = centers[:3] + r.normal(size=(3, 16)) * 0.1
    for nprobe in (1, 2, 4):
        np.testing.assert_array_equal(port_vector.prune_row_groups(path, queries, nprobe),
                                      ref_vector.prune_row_groups(path, queries, nprobe))
    ref, port = _ctxs()
    got = port.read_parquet(path).nearest_neighbors(
        queries, "vec", k=5, payload=["id"], approximate=True, nprobe=2).collect()
    exp = ref.read_parquet(path).nearest_neighbors(
        queries, "vec", k=5, payload=["id"], approximate=True, nprobe=2).collect()
    _same_results(got, exp)


def test_ann_query_prunes_and_recall_holds(tmp_path):
    """tests/test_cloud_readers.py's ANN query, through the port."""
    path, centers, r = _clustered_parquet(tmp_path, "vecs.parquet")
    port_vector.build_vector_index(path, "vec", n_cells=16, iters=5, device="cpu")
    queries = centers[:3] + r.normal(size=(3, 16)) * 0.1
    keep = port_vector.prune_row_groups(path, queries, nprobe=2)
    assert keep is not None and 0 < len(keep) <= 16
    _, port = _ctxs()
    exact = port.read_parquet(path).nearest_neighbors(queries, "vec", k=5,
                                                      payload=["id"]).collect()
    approx = port.read_parquet(path).nearest_neighbors(
        queries, "vec", k=5, payload=["id"], approximate=True, nprobe=4).collect()
    assert len(approx) == len(exact) == 15
    overlap = len(set(map(tuple, approx[["query_idx", "id"]].to_numpy()))
                  & set(map(tuple, exact[["query_idx", "id"]].to_numpy())))
    assert overlap >= 12, overlap


def test_ann_prune_does_not_leak_to_exact_queries(tmp_path):
    """tests/test_cloud_readers.py's leak test, through the port: the same
    source re-queried exactly scans every row group again."""
    r = np.random.default_rng(1)
    n, dim = 2000, 8
    vecs = r.normal(size=(n, dim)).astype(np.float32)
    path = str(tmp_path / "v.parquet")
    pq.write_table(_vec_table(vecs).rename_columns(["id", "vec"]), path, row_group_size=256)
    port_vector.build_vector_index(path, "vec", n_cells=8, iters=3, device="cpu")
    q = vecs[:2]
    _, port = _ctxs()
    src = port.read_parquet(path)
    src.nearest_neighbors(q, "vec", 3, payload=["id"], approximate=True, nprobe=1).collect()
    exact = src.nearest_neighbors(q, "vec", 3, payload=["id"]).collect()
    xn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    sims = qn @ xn.T
    for qi in range(2):
        assert set(exact[exact.query_idx == qi].id) == set(np.argsort(-sims[qi])[:3])
