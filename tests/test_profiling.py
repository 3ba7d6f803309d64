"""Observability utilities (utils/profiling.py).

The reference has no profiling layer at all (SURVEY.md §5 — stdout
narration only); these are the framework's replacement, so they get the
same unit coverage as any other component: Timer spans produce real
elapsed/rate numbers and one JSON log line, sync() forces completion,
trace()/profile_to() drive jax.profiler without error.
"""

import json
import logging
import time

import jax
import jax.numpy as jnp
import pytest

from tsdf_tpu.utils import profiling


def test_sync_returns_scalar_checksum():
    # sync() blocks with block_until_ready and hands its argument back
    # (no host round trip); the values it returns are the computed ones
    a = jnp.arange(8.0)
    assert profiling.sync(a) is a
    x = {"a": jnp.arange(8.0), "b": jnp.ones((2, 2))}
    out = profiling.sync(x)
    assert float(jnp.sum(out["a"])) == pytest.approx(28.0)
    assert float(jnp.sum(out["b"])) == pytest.approx(4.0)


def test_timer_elapsed_rates_and_json_log(caplog):
    with caplog.at_level(logging.INFO, logger="tsdf_tpu"):
        with profiling.Timer("span", voxels=1000) as t:
            time.sleep(0.01)
            t.result = jnp.ones(4)
    assert t.elapsed is not None and t.elapsed >= 0.01
    assert t.rate("voxels") == pytest.approx(1000 / t.elapsed)
    # exactly one structured record per span, from OUR logger (a record
    # propagated by another library mid-span must not break the parse)
    records = [r for r in caplog.records if r.name == "tsdf_tpu"]
    assert len(records) == 1
    payload = json.loads(records[0].message)
    assert payload["span"] == "span"
    assert payload["ms"] >= 10.0
    assert payload["voxels_per_s"] == pytest.approx(t.rate("voxels"))


def test_timer_propagates_exceptions_without_masking():
    with pytest.raises(ValueError, match="boom"):
        with profiling.Timer("bad"):
            raise ValueError("boom")


def test_trace_annotation_context():
    with profiling.trace("region"):
        y = jax.jit(lambda a: a * 2)(jnp.ones(8))
    assert float(y.sum()) == 16.0


def test_profile_to_writes_trace(tmp_path):
    with profiling.profile_to(str(tmp_path)):
        profiling.sync(jax.jit(lambda a: a + 1)(jnp.ones(16)))
    # a TensorBoard-loadable plugin dir must exist with at least one file
    produced = list(tmp_path.rglob("*"))
    assert any(p.is_file() for p in produced)


def test_configure_logging_idempotent_level():
    before = list(profiling.log.handlers)
    try:
        profiling.configure_logging(logging.DEBUG)
        assert profiling.log.level == logging.DEBUG
        n_after_first = len(profiling.log.handlers)
        profiling.configure_logging(logging.INFO)
        assert profiling.log.level == logging.INFO
        # idempotent: the second call must not add another handler
        assert len(profiling.log.handlers) == n_after_first <= len(before) + 1
    finally:
        # remove any handler this test added so later tests don't get
        # duplicate stderr output
        for h in profiling.log.handlers[:]:
            if h not in before:
                profiling.log.removeHandler(h)
