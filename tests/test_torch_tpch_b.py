"""The PyTorch port's TPC-H Q14, Q15, Q16, Q17, Q18, Q20 and Q22 end to end on
the CPU, against the reference (quokka_tpu, JAX x64) and pandas, on
tpch_data tables (sf 0.003: uniform, Zipf-skewed, and skewed with nulls,
where the reference is the only oracle) read from Parquet with
io_channels=2 and exec_channels=2, under both join_build strategies and
both broadcast layouts; no batch may leave the fused kernels or take the
per-step stage path.  The queries, oracles and tolerances are in
tests/torch_tpch_queries.py."""

import pytest

from torch_port_util import fresh_aot  # noqa: F401
from torch_tpch_queries import DATA, STRATEGIES, THRESHOLDS, make_env, run_case

QUERIES_HERE = ["q14", "q15", "q16", "q17", "q18", "q20", "q22"]
_REFERENCE = {}


@pytest.fixture(scope="module", params=list(DATA))
def env(request, tmp_path_factory):
    return make_env(request.param, tmp_path_factory)


@pytest.mark.parametrize("query", QUERIES_HERE)
@pytest.mark.parametrize("layout", list(THRESHOLDS))
@pytest.mark.parametrize("join_build", STRATEGIES)
def test_query_matches_reference_and_pandas(env, query, layout, join_build, monkeypatch,
                                            fresh_aot):
    run_case(env, query, layout, join_build, monkeypatch, _REFERENCE)
