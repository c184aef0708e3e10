"""Host execution infrastructure depth (reference analog:
core/execution/manager.py:35-800 + core/load_balancer.py:33-296 +
foundation/progress.py:37-300): executor reuse/refcount, named configs,
parallel_map ordering + errors, worker quantization, balancer history,
progress tracking.
"""

import threading
import time

import numpy as np
import pytest

from waveformanalysis_tpu.execution.load_balancer import (
    DynamicLoadBalancer,
    quantize_workers,
)
from waveformanalysis_tpu.execution.manager import (
    ExecutorManager,
    get_executor,
    is_picklable,
    parallel_apply,
    parallel_map,
    resolve_executor_config,
)
from waveformanalysis_tpu.foundation.progress import ProgressTracker


def _worker_platform():
    import jax

    return jax.config.jax_platforms, jax.default_backend()


class TestExecutorManager:
    def test_process_workers_pinned_to_cpu(self, monkeypatch):
        """A spawned worker inherits the parent's JAX_PLATFORMS (here one
        this host cannot open) and still runs jax on the CPU only."""
        from waveformanalysis_tpu.execution.manager import cpu_process_pool

        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        with cpu_process_pool(1) as pool:
            platforms, backend = pool.submit(_worker_platform).result(
                timeout=120)
        assert platforms == "cpu"
        assert backend == "cpu"

    def test_pool_reuse_same_key(self):
        mgr = ExecutorManager.instance()
        with get_executor("t1", executor_type="thread", max_workers=2) as a:
            with get_executor("t1", executor_type="thread", max_workers=2) as b:
                assert a is b  # keyed reuse, refcounted

    def test_different_keys_different_pools(self):
        with get_executor("ka", executor_type="thread", max_workers=2) as a:
            with get_executor("kb", executor_type="thread", max_workers=2) as b:
                assert a is not b

    def test_named_configs_resolve(self):
        for name in ("io_intensive", "cpu_intensive", "waveform_loading",
                     "event_grouping", "feature_computation"):
            cfg = resolve_executor_config(name)
            assert cfg.get("executor_type") in ("thread", "process")

    def test_stats_track_pools(self):
        mgr = ExecutorManager.instance()
        with get_executor("stats_probe", executor_type="thread",
                          max_workers=1):
            stats = mgr.get_stats()
            assert stats["active_pools"] >= 1

    def test_shutdown_idle(self):
        mgr = ExecutorManager.instance()
        with get_executor("idle_probe", executor_type="thread", max_workers=1):
            pass  # refcount back to zero -> idle
        closed = mgr.shutdown_idle()
        assert closed >= 1


class TestParallelHelpers:
    def test_parallel_map_preserves_order(self):
        out = parallel_map(lambda x: x * x, list(range(20)),
                           executor_type="thread", max_workers=4)
        assert out == [x * x for x in range(20)]

    def test_parallel_map_propagates_errors(self):
        def boom(x):
            if x == 7:
                raise ValueError("seven")
            return x

        with pytest.raises(ValueError, match="seven"):
            parallel_map(boom, list(range(10)), executor_type="thread",
                         max_workers=2)

    def test_parallel_apply_thunks(self):
        calls = []
        lock = threading.Lock()

        def make(x):
            def thunk():
                with lock:
                    calls.append(x)
                return x
            return thunk

        out = parallel_apply([make(i) for i in range(8)],
                             executor_type="thread", max_workers=3)
        assert out == list(range(8))
        assert sorted(calls) == list(range(8))

    def test_is_picklable(self):
        assert is_picklable([1, 2, 3])
        assert not is_picklable(threading.Lock())


class TestLoadBalancer:
    def test_quantize_powers_of_two(self):
        assert quantize_workers(1) == 1
        assert quantize_workers(3) == 2
        assert quantize_workers(5) == 4
        assert quantize_workers(9) == 8
        assert quantize_workers(9, max_workers=4) == 4

    def test_optimal_workers_bounded(self):
        lb = DynamicLoadBalancer()
        w = lb.get_optimal_workers(max_workers=8)
        assert 1 <= w <= 8

    def test_suggest_batch_size(self):
        lb = DynamicLoadBalancer()
        # 1 MB/item with a 16 MB budget: 16-item fit, floored at min_batch
        b = lb.suggest_batch_size(n_items=100_000, bytes_per_item=1 << 20,
                                  memory_budget_bytes=16 << 20, min_batch=8)
        assert b == 16
        assert lb.suggest_batch_size(10, bytes_per_item=0) == 10

    def test_history_prefers_best_throughput(self):
        lb = DynamicLoadBalancer()
        lb.record_task(duration_s=10.0, n_items=100, workers=2)  # 10/s
        lb.record_task(duration_s=2.0, n_items=100, workers=4)   # 50/s
        lb.record_task(duration_s=8.0, n_items=100, workers=8)   # 12.5/s
        assert lb.best_known_workers() == 4
        tp = lb.throughput_by_workers()
        assert tp[4] > tp[2]


class TestProgressTracker:
    def test_track_update_close(self, capsys):
        pt = ProgressTracker(enabled=True, use_tqdm=False)
        pt.track("load", total=10)
        for _ in range(10):
            pt.update("load", 1)
        pt.close("load")

    def test_disabled_is_noop(self):
        pt = ProgressTracker(enabled=False)
        pt.track("x", total=5)
        pt.update("x", 5)
        pt.close("x")

    def test_unknown_bar_tolerated(self):
        pt = ProgressTracker(enabled=True, use_tqdm=False)
        pt.update("never_opened", 1)
        pt.close("never_opened")
