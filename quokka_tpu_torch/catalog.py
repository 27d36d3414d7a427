"""Catalog: sampling-based cardinality estimation (port of
``quokka_tpu/catalog.py``).

Sample a slice of a source, run the pushed-down predicate on the sample
(plain torch on the CPU), and scale the selectivity by the source's size.
The optimizer's ``choose_broadcast`` uses it.  Samples are numpy
``HostTable``s: Arrow and Parquet inputs are converted, and a reader of
another kind takes part when it offers ``num_rows`` and ``sample(rows)``.
"""

from __future__ import annotations

from typing import Dict, Optional

from quokka_tpu_torch.expression import Expr
from quokka_tpu_torch.ops import bridge, kernels
from quokka_tpu_torch.ops.bridge import HostTable
from quokka_tpu_torch.ops.expr_compile import CompileError, evaluate_predicate

SAMPLE_ROWS = 8192


class Catalog:
    def __init__(self):
        self._cache: Dict[tuple, Optional[float]] = {}

    def estimate_source(self, reader, predicate: Optional[Expr]) -> Optional[float]:
        """Estimated output rows of a source under ``predicate``; None if the
        reader cannot report its size.  Cached per (reader, predicate)."""
        # keyed on the reader object itself: the key keeps it alive, so it
        # cannot be reused after garbage collection as an id() could
        key = (reader, predicate.sql() if predicate is not None else None)
        if key not in self._cache:
            self._cache[key] = self._estimate(reader, predicate)
        return self._cache[key]

    def _estimate(self, reader, predicate: Optional[Expr]) -> Optional[float]:
        total = self._total_rows(reader)
        if total is None:
            return None
        if predicate is None:
            return float(total)
        sample = self._sample(reader)
        if sample is None or sample.num_rows == 0:
            return float(total)
        try:
            keep = predicate.required_columns()
            b = bridge.host_to_device(sample.select([c for c in sample.column_names
                                                     if c in keep]), "cpu")
            kept = kernels.apply_mask(b, evaluate_predicate(predicate, b)).count_valid()
        except (CompileError, KeyError):
            return float(total)
        return float(total) * kept / sample.num_rows

    def _total_rows(self, reader) -> Optional[int]:
        from quokka_tpu_torch.dataset.readers import (
            InputArrowDataset,
            InputHostDataset,
            InputParquetDataset,
            _expand_paths,
        )

        if isinstance(reader, (InputArrowDataset, InputHostDataset)):
            return reader.table.num_rows
        if isinstance(reader, InputParquetDataset):
            import pyarrow.parquet as pq

            return sum(pq.ParquetFile(f).metadata.num_rows for f in _expand_paths(reader.path))
        n = getattr(reader, "num_rows", None)
        return int(n) if n is not None else None

    def _sample(self, reader) -> Optional[HostTable]:
        from quokka_tpu_torch.dataset.readers import (
            InputArrowDataset,
            InputHostDataset,
            InputParquetDataset,
            _expand_paths,
        )

        if isinstance(reader, InputHostDataset):
            return reader.table.slice(0, SAMPLE_ROWS)
        if isinstance(reader, InputArrowDataset):
            return bridge.arrow_to_host(reader.table.slice(0, SAMPLE_ROWS))
        if isinstance(reader, InputParquetDataset):
            import pyarrow as pa
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(_expand_paths(reader.path)[0])
            try:
                table = pa.Table.from_batches([next(pf.iter_batches(batch_size=SAMPLE_ROWS))])
            except StopIteration:
                return None
            return bridge.arrow_to_host(table)
        sample = getattr(reader, "sample", None)
        return sample(SAMPLE_ROWS) if sample is not None else None
