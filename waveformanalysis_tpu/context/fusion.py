"""Fused subgraph execution: lower several plugins into ONE device program.

The reference executes its plugin DAG strictly one plugin at a time, each
materializing its output before the next starts
(reference: waveform_analysis/core/context_execution.py:293-475). On a
device that wastes the expensive resources: the padded wave matrix would be
re-uploaded and re-swept once per plugin, and every plugin pays its own
dispatch through the host->device link.

Here the Context behaves like a graph compiler: when the needed set of an
execution plan contains several wave-derived plugins that share the same
wave source, their ``device_stage`` programs are composed into a single
``jax.jit`` program. XLA then sees all of them at once — the f32 conversion
and polarity-normalized signal are computed once, every kernel reads the
wave matrix from the same HBM residency, and the host pays ONE upload + ONE
dispatch + ONE device_get for the whole bundle.

Correctness contract: fusion is a pure execution strategy. Each member
plugin's ``kernel_config`` / ``host_prep`` / ``device_stage`` / ``finalize``
phases are exactly the ones its standalone ``compute`` runs, so outputs are
bit-identical, lineage/cache keys are untouched, and save_when semantics
apply per plugin as usual (tests/test_fusion.py asserts equality).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# members whose device_stage runs inside the ONE jit program (they sweep the
# wave matrix); waveform_width consumes the hit member's peak slots on device
FUSED_DEVICE_MEMBERS = (
    "basic_features", "hit", "hit_threshold", "waveform_width_integral",
    "waveform_width",
)
# members computed on host INSIDE the bundle from other members' finalized
# tables (hits are orders of magnitude fewer than samples, so these are
# bandwidth-trivial; running them in the bundle removes their standalone
# round trips and re-reads)
FUSED_HOST_MEMBERS = (
    "hit_merge_clusters", "hit_merged", "hit_merged_components", "s1_s2",
)
FUSED_CHAIN_MEMBERS = FUSED_DEVICE_MEMBERS + FUSED_HOST_MEMBERS

# members whose device stage emits fixed-capacity (n, K) slot tables; the
# fused program compacts valid slots ON DEVICE so the device->host fetch
# carries only real hits, not the K-slot padding (at 65536x8 slots the full
# tables are ~37 MB). Fields are packed in this order, rows first.
_SLOT_FIELDS = {
    "hit": ("position", "peak_heights", "left_ips", "right_ips"),
    "hit_threshold": (
        "position", "height", "integral", "seg_start", "seg_end",
        "run_start", "run_end",
    ),
    "waveform_width": (
        "position", "rise_samples", "fall_samples", "total_samples",
        "peak_height", "width_valid",
    ),
}
# (count key, capacity cfg key) used for the device-side overflow counter
# (waveform_width has none: its rows mirror the hit member's slots, whose
# counter already reports capacity overflow)
_SLOT_OVERFLOW = {
    "hit": ("n_candidates", "max_peaks"),
    "hit_threshold": ("n_runs", "max_hits"),
}

# sticky slot-capacity buckets: observed per-event max candidate counts are
# recorded per (run, member lineage) in cache metadata, so a LATER compute
# over the same run+lineage compiles a right-sized K program instead of the
# static default capacity (slot passes and compaction scale with K; not yet
# measured on the GPU). Capacity knobs are
# untracked options, so a shrunken K leaves lineage/cache keys untouched;
# bit-identity is guaranteed by construction: every hinted stage emits an
# overflow counter against its shrunken capacity, and any overflow (stale
# hint — e.g. data re-injected under the same run id) discards the hint and
# re-dispatches the unhinted program. Disable via config
# ``{"capacity_hints": False}``.
_CAP_BUCKETS = (8, 16, 32)

# device_stage-relevant config keys per member: the jit program is cached on
# these (host-only keys like channel_config affect inputs, not the program)
_DEVICE_CFG_KEYS = {
    "basic_features": ("height_range", "area_range"),
    "hit": (
        "use_derivative", "height", "distance", "prominence", "width",
        "height_method", "height_window_extension", "max_peaks", "backend",
    ),
    "hit_threshold": (
        "left_extension", "right_extension", "max_hits", "backend",
    ),
    "waveform_width_integral": ("q_low", "q_high"),
    "waveform_width": (
        "rise_low", "rise_high", "fall_high", "fall_low", "interpolation",
    ),
}


def _wave_input_array(waves):
    """Host waves -> C-contiguous ndarray; device waves pass through so the
    fused program consumes the HBM-resident matrix without a host round
    trip (device_unpack pipelines)."""
    from waveformanalysis_tpu.plugins.builtin._wave_source import (
        wave_matrix_view,
    )

    out = wave_matrix_view(waves)
    if isinstance(out, np.ndarray):
        out = np.ascontiguousarray(out)
    return out


class WaveChainFusion:
    """Fuses basic_features / hit / hit_threshold over a shared wave source."""

    name = "wave_chain"

    def __init__(self) -> None:
        self._programs: Dict[Tuple, Any] = {}

    # -- applicability -------------------------------------------------------

    @staticmethod
    def _expected_classes() -> Dict[str, Any]:
        from waveformanalysis_tpu.plugins.builtin.basic_features import (
            BasicFeaturesPlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.hit_finder import (
            ThresholdHitPlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.hit_merge import (
            HitMergeClustersPlugin,
            HitMergedComponentsPlugin,
            HitMergePlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.peak_finding import (
            HitFinderPlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.s1_s2_classifier import (
            S1S2ClassifierPlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.waveform_width import (
            WaveformWidthPlugin,
        )
        from waveformanalysis_tpu.plugins.builtin.waveform_width_integral import (
            WaveformWidthIntegralPlugin,
        )

        return {
            "basic_features": BasicFeaturesPlugin,
            "hit": HitFinderPlugin,
            "hit_threshold": ThresholdHitPlugin,
            "waveform_width_integral": WaveformWidthIntegralPlugin,
            "waveform_width": WaveformWidthPlugin,
            "hit_merged": HitMergePlugin,
            "hit_merge_clusters": HitMergeClustersPlugin,
            "hit_merged_components": HitMergedComponentsPlugin,
            "s1_s2": S1S2ClassifierPlugin,
        }

    @staticmethod
    def _is_builtin(ctx: Any, name: str, expected: Dict[str, Any]) -> bool:
        """Only the builtin implementations are fusable: a subclass with its
        own compute must run through the normal path."""
        plugin = ctx._plugins.get(name)
        return (plugin is not None
                and type(plugin).compute is expected[name].compute)

    @staticmethod
    def _member_source(ctx: Any, name: str) -> Optional[str]:
        """Wave-source data name a device member's kernels read."""
        from waveformanalysis_tpu.plugins.builtin._wave_source import (
            resolve_wave_input_spec,
        )

        plugin = ctx._plugins[name]
        try:
            if name == "waveform_width":
                return plugin.expected_wave_source(ctx)
            spec = resolve_wave_input_spec(ctx, plugin)
            if spec.is_records:
                # two records-source members may still read DIFFERENT
                # pools (use_filtered -> wave_pool_filtered); a fused
                # bundle uploads one wave matrix, so the pool is part of
                # the source identity
                return f"records:{spec.wave_pool_name}"
            return spec.expected_name
        except Exception:
            return None

    def plan(
        self, ctx: Any, run_id: str, needed: set, min_members: int = 2
    ) -> Optional[List[str]]:
        """Member names this rule can produce in one dispatch, or None.

        Device members must share ONE wave source (the bundle uploads one
        wave matrix); when their sources differ, the largest same-source
        group wins and the rest run standalone. Host members join when
        their inputs are bundle members or already cache-valid:

        - waveform_width additionally needs a usable hit stage over the same
          source — as a bundle member, or recomputed as an unemitted support
          stage when hit is cache-valid (deterministic device program + same
          lineage => identical positions);
        - s1_s2 needs waveform_width in the bundle and basic_features in the
          bundle or cached;
        - the hit_merge family needs hit_threshold in the bundle or cached.
        """
        expected = self._expected_classes()
        members = [m for m in FUSED_CHAIN_MEMBERS if m in needed]
        if len(members) < min_members:
            return None

        # -- device members: group by wave source, keep the largest group --
        by_source: Dict[str, List[str]] = {}
        for m in members:
            if m not in FUSED_DEVICE_MEMBERS:
                continue
            if not self._is_builtin(ctx, m, expected):
                continue
            src = self._member_source(ctx, m)
            if src is not None:
                by_source.setdefault(src, []).append(m)
        if not by_source:
            return None
        source, device = max(
            by_source.items(), key=lambda kv: (len(kv[1]),
                                               kv[0].startswith("records"))
        )

        # waveform_width needs the hit stage over the bundle's source
        if "waveform_width" in device:
            hit_ok = (
                self._is_builtin(ctx, "hit", expected)
                and self._member_source(ctx, "hit") == source
                and ("hit" in device
                     or ctx.cache_domain.is_cache_hit(run_id, "hit"))
            )
            if not hit_ok:
                device = [m for m in device if m != "waveform_width"]
        if not device:
            return None

        # -- host members ---------------------------------------------------
        def available(name: str) -> bool:
            return name in device or ctx.cache_domain.is_cache_hit(
                run_id, name
            )

        host: List[str] = []
        for m in members:
            if m not in FUSED_HOST_MEMBERS:
                continue
            if not self._is_builtin(ctx, m, expected):
                continue
            if m == "s1_s2":
                if available("waveform_width") and available("basic_features"):
                    host.append(m)
            elif available("hit_threshold"):
                host.append(m)

        usable = [m for m in FUSED_CHAIN_MEMBERS if m in device or m in host]
        if len(usable) < min_members:
            return None
        return usable

    def plan_batched(
        self, ctx: Any, run_id: str, needed: set
    ) -> Optional[List[str]]:
        """Batched-dispatch planning: a SINGLE member qualifies — batching
        runs on the event axis amortizes upload/dispatch/fetch latency even
        when only one wave-chain plugin is in the needed set."""
        return self.plan(ctx, run_id, needed, min_members=1)

    # -- execution -----------------------------------------------------------

    def compute(self, ctx: Any, run_id: str, members: List[str]) -> Dict[str, Any]:
        """Run the fused program; returns {data_name: finalized result}."""
        import jax
        import jax.numpy as jnp

        from waveformanalysis_tpu.plugins.builtin.peak_finding import (
            _load_wave_matrix,
        )

        device_members = [m for m in members if m in FUSED_DEVICE_MEMBERS]
        host_members = [m for m in members if m in FUSED_HOST_MEMBERS]
        plugins = {m: ctx._plugins[m] for m in members}
        cfgs = {m: plugins[m].kernel_config(ctx) for m in members}
        support_hit_cfg = self._support_hit_cfg(ctx, device_members)

        # one wave-input load for the whole bundle (keeps the native integer
        # dtype; every device stage casts on device). waveform_width has no
        # wave_source option, so the load rides another member (or the hit
        # plugin, whose source the planner verified matches).
        load_via = next(
            (m for m in device_members if m != "waveform_width"), None
        )
        load_plugin = (
            plugins[load_via] if load_via is not None else ctx._plugins["hit"]
        )
        with ctx.profiler.time("fusion.single.load"):
            waves, lengths, meta = _load_wave_matrix(
                ctx, load_plugin, run_id, keep_integer_waves=True
            )
        n = len(lengths)
        if n == 0:
            return self._empty_results(members)

        # host preps (config machinery producing device inputs)
        sign = np.where(meta["polarity"] > 0, 1.0, -1.0).astype(np.float32)
        thresholds = None
        if "hit_threshold" in device_members:
            thresholds = plugins["hit_threshold"].host_prep(
                cfgs["hit_threshold"], ctx, run_id, meta
            ).astype(np.float32)
        bf_baselines = None
        if "basic_features" in device_members:
            bf_baselines = plugins["basic_features"].host_prep(
                cfgs["basic_features"], ctx, run_id,
                np.asarray(meta["baseline"], dtype=np.float64),
                meta["board"], meta["channel"],
            )

        mesh_info = getattr(ctx, "mesh", None)

        thresholds_np = (
            np.zeros((n,), np.float32) if thresholds is None else thresholds
        )
        inputs = (
            _wave_input_array(waves),
            lengths.astype(np.int32),
            sign,
            meta["baseline"].astype(np.float32),
            thresholds_np,
        )
        slot_out = None
        if mesh_info is not None:
            with ctx.profiler.time("fusion.single.get_program"):
                program, spec_cache = self._get_program(
                    tuple(device_members), cfgs, plugins, mesh_info,
                    support_hit_cfg=support_hit_cfg,
                )
            host_out = self._run_sharded(program, inputs, n, mesh_info)
        else:
            hinted = self._apply_capacity_hints(
                ctx, run_id, device_members, cfgs, support_hit_cfg, n
            )
            with ctx.profiler.time("fusion.single.upload"):
                # async upload: no host sync — the device program's data
                # dependencies order the transfers. Upload time shows up in
                # the fetch phase of the profile.
                dev_in = tuple(jnp.asarray(x) for x in inputs)
            shapes_key = tuple(
                (tuple(x.shape), str(x.dtype)) for x in dev_in
            )
            while True:
                with ctx.profiler.time("fusion.single.get_program"):
                    program, spec_cache = self._get_program(
                        tuple(device_members), cfgs, plugins, None,
                        support_hit_cfg=support_hit_cfg,
                    )
                with ctx.profiler.time("fusion.single.device_program"):
                    # NO block on counts here: with a speculative fetch
                    # bucket the host never needs counts before the packed
                    # transfer. The fetch phase therefore absorbs device
                    # compute time in the profile.
                    flat_d, slot_mats_d, counts_d = program(*dev_in)
                with ctx.profiler.time("fusion.single.fetch"):
                    host_out, slot_out = _fetch_packed_outputs(
                        flat_d, slot_mats_d, counts_d, spec_cache[shapes_key],
                        hint_key=("single", tuple(device_members),
                                  shapes_key),
                    )
                stale = [
                    m for m, orig in hinted.items()
                    if int(np.sum(np.asarray(host_out.get(
                        m + "__overflow",
                        host_out.get("__" + m + "_support__overflow", 0),
                    )))) > 0
                ]
                if not stale:
                    break
                # a hinted capacity overflowed: the recorded hint no longer
                # matches the run's data (e.g. re-injected under the same
                # run id). Restore configured capacities and re-dispatch —
                # outputs stay identical to the never-hinted program.
                logger.warning(
                    "stale slot-capacity hint for %s on run %s; "
                    "re-dispatching at configured capacity", stale, run_id,
                )
                for m in stale:
                    self._drop_hint(ctx, run_id, m)
                for m, orig in hinted.items():
                    for cfg in (
                        [cfgs[m]] if m in device_members else []
                    ) + (
                        [support_hit_cfg]
                        if m == "hit" and support_hit_cfg is not None else []
                    ):
                        cfg[_SLOT_OVERFLOW[m][1]] = orig
                hinted = {}
            self._record_capacity_hints(ctx, run_id, host_out, n)

        results: Dict[str, Any] = {}
        with ctx.profiler.time("fusion.single.finalize"):
            for m in device_members:
                results[m] = self._finalize_member(
                    ctx, m, plugins, cfgs, support_hit_cfg, host_out,
                    slot_out, meta, lengths, n, offset=None,
                    bf_baselines=bf_baselines,
                )
            self._finalize_host_members(
                ctx, run_id, host_members, plugins, cfgs, results
            )
        logger.debug(
            "fused %s over %d waveforms in one device program", members, n
        )
        return results

    @staticmethod
    def _support_hit_cfg(ctx: Any, device_members: List[str]):
        """Kernel config for the UNEMITTED hit stage backing waveform_width
        when hit itself is cache-valid and outside the bundle."""
        if "waveform_width" in device_members and "hit" not in device_members:
            return ctx._plugins["hit"].kernel_config(ctx)
        return None

    # -- sticky slot-capacity hints -------------------------------------------

    @staticmethod
    def _hint_store(ctx: Any) -> Dict[str, Optional[int]]:
        store = getattr(ctx, "_slot_capacity_hints", None)
        if store is None:
            store = {}
            ctx._slot_capacity_hints = store
        return store

    @staticmethod
    def _hint_key(ctx: Any, run_id: str, member: str) -> str:
        # lineage-hashed like the data caches: a config/version change that
        # could alter candidate counts changes the key, orphaning the hint
        return ctx.cache_domain.key_for(run_id, member) + "-caphint"

    def _get_hint(self, ctx: Any, run_id: str, member: str, n: int):
        """Observed max per-event candidate count, or None. ``n`` guards
        against re-injected data: a hint recorded over a different event
        count is ignored."""
        key = self._hint_key(ctx, run_id, member)
        store = self._hint_store(ctx)
        if key not in store:
            entry = None
            try:
                storage = ctx._get_storage_for_data_name(member)
                meta = storage.get_metadata(key, run_id)
                if meta and "max_slot_count" in meta:
                    entry = (int(meta["max_slot_count"]),
                             int(meta.get("n_events", -1)))
            except Exception:  # noqa: BLE001 - hint misses are never fatal
                entry = None
            store[key] = entry
        entry = store[key]
        if entry is None or entry[1] != n:
            return None
        return entry[0]

    def _put_hint(
        self, ctx: Any, run_id: str, member: str, observed: int, n: int
    ) -> None:
        key = self._hint_key(ctx, run_id, member)
        self._hint_store(ctx)[key] = (observed, n)
        try:
            storage = ctx._get_storage_for_data_name(member)
            storage.save_metadata(
                key, {"max_slot_count": int(observed), "n_events": int(n)},
                run_id,
            )
        except Exception as e:  # noqa: BLE001
            logger.debug("capacity hint persist failed for %s: %s", key, e)

    def _drop_hint(self, ctx: Any, run_id: str, member: str) -> None:
        key = self._hint_key(ctx, run_id, member)
        self._hint_store(ctx)[key] = None
        try:
            storage = ctx._get_storage_for_data_name(member)
            storage.save_metadata(key, {}, run_id)
        except Exception:  # noqa: BLE001
            pass

    def _apply_capacity_hints(
        self, ctx: Any, run_id: str, device_members: List[str],
        cfgs: Dict, support_hit_cfg, n: int,
    ) -> Dict[str, int]:
        """Shrink slot capacities to the smallest bucket covering the
        recorded hint; returns {member: original capacity} for the stale-
        hint rerun path. Only ever shrinks — a hint above the configured
        capacity never widens it."""
        if not ctx.config.get("capacity_hints", True):
            return {}
        hinted: Dict[str, int] = {}
        for m, (_count_key, cap_key) in _SLOT_OVERFLOW.items():
            targets = []
            if m in device_members:
                targets.append(cfgs[m])
            if m == "hit" and support_hit_cfg is not None:
                targets.append(support_hit_cfg)
            if not targets:
                continue
            hint = self._get_hint(ctx, run_id, m, n)
            if hint is None:
                continue
            new = next((b for b in _CAP_BUCKETS if b >= max(hint, 1)), None)
            if new is None:
                continue
            for cfg in targets:
                if new < cfg[cap_key]:
                    hinted.setdefault(m, cfg[cap_key])
                    cfg[cap_key] = new
        return hinted

    def _record_capacity_hints(
        self, ctx: Any, run_id: str, host_out: Dict, n: int,
    ) -> None:
        for m in _SLOT_OVERFLOW:
            for key in (m + "__max_count", "__" + m + "_support__max_count"):
                if key in host_out:
                    self._put_hint(
                        ctx, run_id, m, int(np.asarray(host_out[key])), n
                    )
                    break

    def _finalize_member(
        self, ctx: Any, m: str, plugins: Dict, cfgs: Dict, support_hit_cfg,
        host_out: Dict, slot_out, meta: dict, lengths: np.ndarray, n: int,
        offset, per_run_lengths=None, bf_baselines=None,
    ):
        """Finalize ONE device member from fetched outputs.

        ``offset=None`` = single-run path (whole arrays); otherwise the
        batched path passes (offset, n) so dense leaves slice and slot rows
        rebase. ``per_run_lengths`` carries the run's own lengths column for
        hit_threshold in the batched path.
        """
        import jax as _jax

        def dense(name):
            tree = host_out[name]
            if offset is None:
                return tree
            return _jax.tree_util.tree_map(
                lambda a: a[offset:offset + n], tree
            )

        def slot_rows(name):
            rows, slots = slot_out[name]
            if offset is None:
                return rows, slots, None
            lo = int(np.searchsorted(rows, offset))
            hi = int(np.searchsorted(rows, offset + n))
            return rows[lo:hi] - offset, \
                {f: c[lo:hi] for f, c in slots.items()}, (lo, hi)

        lengths_col = lengths if per_run_lengths is None else per_run_lengths

        if m == "basic_features":
            pol = np.where(
                meta["polarity"] == 0, np.int8(-1), meta["polarity"]
            ).astype(np.int8)
            return plugins[m].finalize(
                cfgs[m], dense(m), bf_baselines, pol,
                meta["timestamp"], meta["board"], meta["channel"],
            )
        if m == "hit":
            if slot_out is not None:
                rows, slots, _ = slot_rows(m)
                return plugins[m].finalize_compact(
                    cfgs[m], rows, slots, self._member_overflow(
                        host_out, m, offset, n), meta, n,
                )
            return plugins[m].finalize(cfgs[m], dense(m), meta, n)
        if m == "hit_threshold":
            if slot_out is not None:
                rows, slots, _ = slot_rows(m)
                return plugins[m].finalize_compact(
                    cfgs[m], rows, slots, self._member_overflow(
                        host_out, m, offset, n),
                    meta, np.asarray(lengths_col, np.int64), n,
                )
            return plugins[m].finalize(
                cfgs[m], dense(m), meta, np.asarray(lengths_col, np.int64), n
            )
        if m == "waveform_width_integral":
            return plugins[m].finalize(cfgs[m], dense(m), meta, n)
        if m == "waveform_width":
            hit_cfg = cfgs.get("hit") or support_hit_cfg
            dt_ns = ctx._plugins["hit"]._resolve_dt(hit_cfg, meta, n)
            if slot_out is not None:
                rows, slots, _ = slot_rows(m)
                return plugins[m].finalize_compact(
                    cfgs[m], rows, slots, meta, dt_ns
                )
            return plugins[m].finalize(cfgs[m], dense(m), meta, dt_ns)
        raise KeyError(m)

    @staticmethod
    def _member_overflow(host_out: Dict, m: str, offset, n: int) -> int:
        over = host_out[m + "__overflow"]
        if offset is None:
            return int(np.sum(over))
        return int(np.asarray(over)[offset:offset + n].sum())

    @staticmethod
    def _finalize_host_members(
        ctx: Any, run_id: str, host_members: List[str], plugins: Dict,
        cfgs: Dict, results: Dict[str, Any],
    ) -> None:
        """Compute the bundle's host members from finalized member tables.

        Inputs outside the bundle are cache-valid by the planner's contract
        and load through the normal (cached) get_data path. The SAME pure
        functions the standalone computes call run here, so outputs are
        bit-identical (reference cones: s1_s2_classifier.py:73,
        hit_merge.py:325-445).
        """
        if not host_members:
            return

        def table_input(name: str):
            if name in results:
                return results[name]
            return ctx.get_data(run_id, name)

        if "s1_s2" in host_members:
            results["s1_s2"] = plugins["s1_s2"].classify(
                cfgs["s1_s2"], table_input("waveform_width"),
                table_input("basic_features"),
            )
        merge_members = [m for m in host_members if m != "s1_s2"]
        if merge_members:
            from waveformanalysis_tpu.plugins.builtin.hit_merge import (
                clusters_table,
                components_table,
                merge_from_table,
                merged_table,
            )

            emit = {
                "hit_merged": merged_table,
                "hit_merge_clusters": clusters_table,
                "hit_merged_components": components_table,
            }
            hits_th = table_input("hit_threshold")
            triples: Dict[Tuple, Any] = {}
            for m in merge_members:
                ckey = tuple(sorted(
                    (k, v) for k, v in cfgs[m].items()
                ))
                if ckey not in triples:
                    # one merge per distinct config serves every member that
                    # shares it (standalone runs the merge once per plugin)
                    triples[ckey] = merge_from_table(cfgs[m], hits_th)
                results[m] = emit[m](triples[ckey])

    # -- multi-run batched execution ----------------------------------------

    def compute_many(
        self, ctx: Any, run_members: List[Tuple[str, List[str]]]
    ) -> Dict[str, Dict[str, Any]]:
        """Run the fused bundle for SEVERAL runs in as few device programs
        as possible.

        The reference fans multiple runs out over host processes
        (reference: waveform_analysis/core/data/batch_processor.py:197); on
        a device the idiomatic axis is the batch dimension: runs whose device
        configuration matches are CONCATENATED along the event axis and
        dispatched as ONE program, so R runs pay one dispatch + one packed
        fetch instead of R of each. Outputs are split at the run boundaries
        on host and finalized/saved per run — bit-identical to per-run
        execution (tests/test_batched_dispatch.py).

        The concatenated event count is padded up to a multiple of
        ``config["fused_batch_bucket"]`` (default 4096) with zero-length
        events so repeated batched calls reuse a small set of compiled
        programs. Zero-length padding is the same contract _run_sharded
        relies on: no samples -> no features, no peaks, no hits.
        """
        import jax
        import jax.numpy as jnp

        out: Dict[str, Dict[str, Any]] = {}

        # per-run prep under that run's prepared request (run_config may
        # differ per run, so group keys include the device-relevant cfg)
        groups: Dict[Tuple, List[dict]] = {}
        for run_id, members in run_members:
            ctx.config_domain.prepare_request(run_id)
            with ctx.profiler.time("fusion.batched.prep_run"):
                prep = self._prep_run(ctx, run_id, members)
            if prep is None:  # empty run: finalize immediately
                out[run_id] = self._empty_results(members)
                continue
            groups.setdefault(prep.pop("group_key"), []).append(prep)

        for key, preps in groups.items():
            # singleton groups also dispatch through the bucket-padded
            # program: the prep work is reused, and the padded shapes are
            # the SAME ones other batched calls compile, so a lone
            # odd-config run shares compiled programs instead of forcing
            # the standard-shape variant
            out.update(self._dispatch_group(ctx, preps))
        return out

    def _prep_run(self, ctx: Any, run_id: str, members: List[str]):
        """Load + host-prep one run's bundle inputs; None for empty runs."""
        from waveformanalysis_tpu.plugins.builtin.peak_finding import (
            _load_wave_matrix,
        )

        device_members = [m for m in members if m in FUSED_DEVICE_MEMBERS]
        plugins = {m: ctx._plugins[m] for m in members}
        cfgs = {m: plugins[m].kernel_config(ctx) for m in members}
        support_hit_cfg = self._support_hit_cfg(ctx, device_members)
        load_via = next(
            (m for m in device_members if m != "waveform_width"), None
        )
        load_plugin = (
            plugins[load_via] if load_via is not None else ctx._plugins["hit"]
        )
        waves, lengths, meta = _load_wave_matrix(
            ctx, load_plugin, run_id, keep_integer_waves=True
        )
        n = len(lengths)
        if n == 0:
            return None

        sign = np.where(meta["polarity"] > 0, 1.0, -1.0).astype(np.float32)
        thresholds = np.zeros((n,), np.float32)
        if "hit_threshold" in device_members:
            thresholds = plugins["hit_threshold"].host_prep(
                cfgs["hit_threshold"], ctx, run_id, meta
            ).astype(np.float32)
        bf_baselines = None
        if "basic_features" in device_members:
            bf_baselines = plugins["basic_features"].host_prep(
                cfgs["basic_features"], ctx, run_id,
                np.asarray(meta["baseline"], dtype=np.float64),
                meta["board"], meta["channel"],
            )

        cfg_key = tuple(
            (m, tuple((k, cfgs[m][k]) for k in _DEVICE_CFG_KEYS[m]))
            for m in device_members
        )
        if support_hit_cfg is not None:
            cfg_key += (("__hit_support", tuple(
                (k, support_hit_cfg[k])
                for k in _DEVICE_CFG_KEYS["hit"]
            )),)
        return {
            "run_id": run_id,
            "members": list(members),
            "device_members": device_members,
            "host_members": [m for m in members if m in FUSED_HOST_MEMBERS],
            "plugins": plugins,
            "cfgs": cfgs,
            "support_hit_cfg": support_hit_cfg,
            "waves": _wave_input_array(waves),
            "lengths": lengths.astype(np.int32),
            "sign": sign,
            "baseline_f32": meta["baseline"].astype(np.float32),
            "thresholds": thresholds,
            "bf_baselines": bf_baselines,
            "meta": meta,
            "n": n,
            "group_key": (tuple(members), cfg_key, str(waves.dtype)),
        }

    def _dispatch_group(
        self, ctx: Any, preps: List[dict]
    ) -> Dict[str, Dict[str, Any]]:
        """One concatenated device program for runs with matching config."""
        import jax
        import jax.numpy as jnp

        members = preps[0]["members"]
        device_members = preps[0]["device_members"]
        cfgs = preps[0]["cfgs"]
        plugins = preps[0]["plugins"]
        support_hit_cfg = preps[0]["support_hit_cfg"]

        L = max(p["waves"].shape[1] for p in preps)
        total = sum(p["n"] for p in preps)
        bucket = int(ctx.config.get("fused_batch_bucket", 4096))
        padded = ((total + bucket - 1) // bucket) * bucket if bucket > 1 \
            else total
        mesh_info = getattr(ctx, "mesh", None)
        if mesh_info is not None:
            # batched runs compose with event-axis sharding: align the
            # padded batch to the shard count so shard_map splits evenly
            n_shards = mesh_info[0].shape[mesh_info[1]]
            padded = ((padded + n_shards - 1) // n_shards) * n_shards

        wv0 = preps[0]["waves"]
        all_device = all(
            isinstance(p["waves"], jax.Array) for p in preps
        )
        lengths = np.zeros((padded,), np.int32)
        sign = np.ones((padded,), np.float32)
        baselines = np.zeros((padded,), np.float32)
        thresholds = np.zeros((padded,), np.float32)
        offsets = []
        off = 0
        for p in preps:
            n = p["n"]
            lengths[off:off + n] = p["lengths"]
            sign[off:off + n] = p["sign"]
            baselines[off:off + n] = p["baseline_f32"]
            thresholds[off:off + n] = p["thresholds"]
            offsets.append(off)
            off += n
        if all_device:
            # device-resident wave matrices (device_unpack pipelines)
            # concatenate IN HBM — fetching them back to build a host
            # buffer would pay the round trip the residency exists to
            # avoid
            parts = [
                jnp.pad(p["waves"],
                        ((0, 0), (0, L - p["waves"].shape[1])))
                if p["waves"].shape[1] < L else p["waves"]
                for p in preps
            ]
            if padded > total:
                parts.append(jnp.zeros((padded - total, L), wv0.dtype))
            waves = jnp.concatenate(parts, axis=0)
        else:
            waves = np.zeros((padded, L), dtype=np.asarray(wv0).dtype)
            for p, off_p in zip(preps, offsets):
                w = np.asarray(p["waves"])
                waves[off_p:off_p + p["n"], : w.shape[1]] = w

        inputs = (waves, lengths, sign, baselines, thresholds)
        if mesh_info is not None:
            # sharded batched program: raw (unpacked) outputs over the mesh,
            # same path the single-run mesh branch of compute() uses
            program, _spec = self._get_program(
                tuple(device_members), cfgs, plugins, mesh_info,
                support_hit_cfg=support_hit_cfg,
            )
            host_out = self._run_sharded(program, inputs, padded, mesh_info)
            slot_out = None
        else:
            with ctx.profiler.time("fusion.batched.get_program"):
                program, spec_cache = self._get_program(
                    tuple(device_members), cfgs, plugins, None,
                    per_event_overflow=True, support_hit_cfg=support_hit_cfg,
                )
            with ctx.profiler.time("fusion.batched.upload"):
                # async upload: see the single-dispatch path
                dev_in = tuple(jnp.asarray(x) for x in inputs)
            shapes_key = tuple(
                (tuple(x.shape), str(x.dtype)) for x in dev_in
            )
            with ctx.profiler.time("fusion.batched.device_program"):
                # no count block: see the single-dispatch path above
                flat_d, slot_mats_d, counts_d = program(*dev_in)
            with ctx.profiler.time("fusion.batched.fetch"):
                host_out, slot_out = _fetch_packed_outputs(
                    flat_d, slot_mats_d, counts_d, spec_cache[shapes_key],
                    hint_key=("batched", tuple(device_members), shapes_key),
                )

        out: Dict[str, Dict[str, Any]] = {}
        with ctx.profiler.time("fusion.batched.finalize"):
            for p, off in zip(preps, offsets):
                run_id, n, meta = p["run_id"], p["n"], p["meta"]
                results: Dict[str, Any] = {}
                for m in p["device_members"]:
                    results[m] = self._finalize_member(
                        ctx, m, p["plugins"], p["cfgs"],
                        p["support_hit_cfg"],
                        host_out, slot_out, meta, p["lengths"], n,
                        offset=off,
                        per_run_lengths=p["lengths"],
                        bf_baselines=p["bf_baselines"],
                    )
                self._finalize_host_members(
                    ctx, run_id, p["host_members"], p["plugins"], p["cfgs"],
                    results,
                )
                out[run_id] = results
        logger.debug(
            "batched fused %s over %d runs / %d waveforms (padded %d) in one "
            "device program", members, len(preps), total, padded,
        )
        return out

    @staticmethod
    def _empty_results(members: List[str]) -> Dict[str, Any]:
        from waveformanalysis_tpu.dtypes.table import Table
        from waveformanalysis_tpu.plugins.builtin.basic_features import (
            BASIC_FEATURES_SCHEMA,
        )
        from waveformanalysis_tpu.plugins.builtin.hit_finder import (
            THRESHOLD_HIT_SCHEMA,
        )
        from waveformanalysis_tpu.plugins.builtin.peak_finding import HIT_SCHEMA
        from waveformanalysis_tpu.plugins.builtin.waveform_width_integral import (
            WAVEFORM_WIDTH_INTEGRAL_SCHEMA,
        )

        from waveformanalysis_tpu.plugins.builtin.hit_merge import (
            HIT_MERGE_CLUSTERS_SCHEMA,
            HIT_MERGED_COMPONENTS_SCHEMA,
            HIT_MERGED_SCHEMA,
        )
        from waveformanalysis_tpu.plugins.builtin.s1_s2_classifier import (
            S1_S2_CLASSIFIER_SCHEMA,
        )
        from waveformanalysis_tpu.plugins.builtin.waveform_width import (
            WAVEFORM_WIDTH_SCHEMA,
        )

        schemas = {
            "basic_features": BASIC_FEATURES_SCHEMA,
            "hit": HIT_SCHEMA,
            "hit_threshold": THRESHOLD_HIT_SCHEMA,
            "waveform_width_integral": WAVEFORM_WIDTH_INTEGRAL_SCHEMA,
            "waveform_width": WAVEFORM_WIDTH_SCHEMA,
            "hit_merged": HIT_MERGED_SCHEMA,
            "hit_merge_clusters": HIT_MERGE_CLUSTERS_SCHEMA,
            "hit_merged_components": HIT_MERGED_COMPONENTS_SCHEMA,
            "s1_s2": S1_S2_CLASSIFIER_SCHEMA,
        }
        return {m: Table.zeros(0, schemas[m]) for m in members}

    @staticmethod
    def _run_sharded(program, inputs, n: int, mesh_info) -> Dict[str, Any]:
        """Pad the event axis to the shard multiple, run, unpad outputs.

        Pad rows carry event_length 0 (no samples -> no features, no peaks,
        no hits) and are sliced off before finalize.
        """
        import jax
        import numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh, axis = mesh_info
        n_shards = mesh.shape[axis]
        padded_n = ((n + n_shards - 1) // n_shards) * n_shards
        pad = padded_n - n
        if pad:
            inputs = tuple(
                np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                for x in inputs
            )
        put = [
            jax.device_put(
                x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
            )
            for x in inputs
        ]
        out = jax.device_get(program(*put))
        if pad:
            out = jax.tree_util.tree_map(lambda a: a[:n], out)
        return out

    def _get_program(
        self, members: Tuple[str, ...], cfgs: Dict, plugins: Dict,
        mesh_info=None, per_event_overflow: bool = False,
        support_hit_cfg: Optional[dict] = None,
    ):
        """jit program cached on (members, device-relevant config values).

        ``members`` here are the DEVICE members only. ``support_hit_cfg``
        adds an unemitted hit stage feeding waveform_width when hit itself
        is cache-valid and outside the bundle. ``per_event_overflow`` emits
        each slot member's overflow indicator as a per-event (n,) vector
        instead of a scalar sum — the batched multi-run dispatcher needs
        per-run overflow counts, which the host recovers by summing run
        slices.
        """
        import jax

        key_parts: List[Any] = [members]
        for m in members:
            key_parts.append(
                tuple((k, cfgs[m][k]) for k in _DEVICE_CFG_KEYS[m])
            )
        if support_hit_cfg is not None:
            key_parts.append(("__hit_support", tuple(
                (k, support_hit_cfg[k]) for k in _DEVICE_CFG_KEYS["hit"]
            )))
        if mesh_info is not None:
            mesh, axis = mesh_info
            key_parts.append(("mesh", id(mesh), axis))
        if per_event_overflow:
            key_parts.append("per_event_overflow")
        key = tuple(key_parts)
        prog = self._programs.get(key)
        if prog is not None:
            return prog

        stages = {m: type(plugins[m]).device_stage for m in members}
        member_cfgs = {m: dict(cfgs[m]) for m in members}
        hit_support = None
        if support_hit_cfg is not None:
            from waveformanalysis_tpu.plugins.builtin.peak_finding import (
                HitFinderPlugin,
            )

            hit_support = (HitFinderPlugin.device_stage, dict(support_hit_cfg))

        def program(waves_d, lengths_d, sign_d, baselines_d, thresholds_d):
            out = {}
            peaks_stage = None
            for m in members:
                if m == "basic_features":
                    out[m] = stages[m](member_cfgs[m], waves_d, lengths_d)
                elif m == "hit":
                    out[m] = stages[m](
                        member_cfgs[m], waves_d, lengths_d, sign_d, baselines_d
                    )
                    peaks_stage = out[m]
                elif m == "hit_threshold":
                    out[m] = stages[m](
                        member_cfgs[m], waves_d, lengths_d, sign_d,
                        baselines_d, thresholds_d,
                    )
                elif m == "waveform_width_integral":
                    out[m] = stages[m](
                        member_cfgs[m], waves_d, lengths_d, sign_d,
                        baselines_d,
                    )
                elif m == "waveform_width":
                    if peaks_stage is None:
                        fn, s_cfg = hit_support
                        peaks_stage = fn(
                            s_cfg, waves_d, lengths_d, sign_d, baselines_d
                        )
                        # expose the support stage's candidate counts so the
                        # packed path can emit overflow/max-count leaves for
                        # the capacity-hint contract
                        out["__hit_support_counts"] = peaks_stage[
                            _SLOT_OVERFLOW["hit"][0]
                        ]
                    out[m] = stages[m](member_cfgs[m], waves_d, peaks_stage)
            return out

        if mesh_info is not None:
            # event-axis data parallelism: one shard_map over the whole
            # bundle, every stage's outputs sharded on their leading dim.
            # (No transfer-packing here: the flat concat would break the
            # even per-leaf sharding.)
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            mesh, axis = mesh_info
            program = shard_map(
                program,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
            entry = (jax.jit(program), None)
            self._programs[key] = entry
            return entry

        # minimal-transfer packing: the jitted program returns
        #   (dense_flat_i32, per-member compacted slot matrices, counts)
        # Dense (always-(n,)-shaped) leaves concatenate into ONE flat int32
        # array; slot-table members are compacted on device (valid slots
        # front-packed in row-major order) so the host can fetch only the
        # first ``count`` rows of each matrix. The per-shape unpack spec is
        # recorded at trace time.
        spec_cache: Dict[Tuple, Any] = {}

        def packed_program(*args):
            import jax.numpy as jnp

            shapes_key = tuple((tuple(a.shape), str(a.dtype)) for a in args)
            out = program(*args)
            dense_out = {}
            slot_mats = []
            counts = []
            slot_specs = []
            support_counts = out.pop("__hit_support_counts", None)
            if support_counts is not None and not per_event_overflow:
                cap = hit_support[1][_SLOT_OVERFLOW["hit"][1]]
                dense_out["__hit_support__overflow"] = jnp.sum(
                    (support_counts > cap).astype(jnp.int32)
                )
                dense_out["__hit_support__max_count"] = jnp.max(
                    support_counts
                ).astype(jnp.int32)
            for m in members:
                if m not in _SLOT_FIELDS:
                    dense_out[m] = out[m]
                    continue
                stage = out[m]
                fields = _SLOT_FIELDS[m]
                mat, count = _compact_slots(stage, fields)
                slot_mats.append(mat)
                counts.append(count)
                slot_specs.append(
                    (m, fields,
                     tuple(str(stage[f].dtype) for f in fields))
                )
                if m in _SLOT_OVERFLOW:
                    count_key, cap_key = _SLOT_OVERFLOW[m]
                    over = (
                        stage[count_key] > member_cfgs[m][cap_key]
                    ).astype(jnp.int32)
                    dense_out[m + "__overflow"] = (
                        over if per_event_overflow else jnp.sum(over)
                    )
                    if not per_event_overflow:
                        dense_out[m + "__max_count"] = jnp.max(
                            stage[count_key]
                        ).astype(jnp.int32)
            flat, spec = _pack_leaves(dense_out)
            spec_cache[shapes_key] = (spec, slot_specs)
            return flat, tuple(slot_mats), jnp.stack(counts) if counts \
                else jnp.zeros((0,), jnp.int32)

        # persistent AOT layer: later processes skip the ~0.5 s host-side
        # re-trace of this program (foundation/aot_cache.py); the XLA
        # executable cache below it skips the compile. Keyed like the jit
        # cache plus plugin versions (a kernel change invalidates stale
        # programs the way it invalidates data lineage).
        versions = tuple(
            (m, getattr(plugins[m], "version", "?")) for m in members
        )
        if support_hit_cfg is not None:
            from waveformanalysis_tpu.plugins.builtin.peak_finding import (
                HitFinderPlugin as _HFP,
            )

            versions += (("__hit_support", getattr(_HFP, "version", "?")),)
        digest_base = (
            _canon_key(key), versions, jax.__version__,
            bool(jax.config.jax_enable_x64), jax.default_backend(),
        )
        entry = (_AotProgram(packed_program, spec_cache, digest_base),
                 spec_cache)
        self._programs[key] = entry
        return entry


def _canon_key(obj):
    """Process-stable form of a program cache key: numpy scalars -> Python
    scalars so repr() is identical across numpy versions and processes."""
    if isinstance(obj, tuple):
        return tuple(_canon_key(x) for x in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class _AotProgram:
    """jit with a persistent AOT (``jax.export``) layer in front.

    Behaves like ``jax.jit(fun)`` to the caller (the fused dispatch sites
    call it with concrete device arrays), but per argument-shapes:

    - disk HIT: deserialize the traced StableHLO (~1 ms), restore the
      transfer-packing spec into ``spec_cache``, execute through
      ``jit(exported.call)`` — no Python re-trace; the XLA executable
      cache covers the compile.
    - disk MISS: plain jit call (traces once, populating ``spec_cache``
      as a trace-time side effect), then export+persist OFF-thread so the
      critical path never pays the export.

    Outputs are bit-identical between the two paths (the exported module
    IS this trace's lowering) — pinned in tests/test_aot_cache.py.
    """

    def __init__(self, fun, spec_cache, digest_base):
        self._fun = fun
        self._jit = None
        self._spec_cache = spec_cache
        self._digest_base = digest_base
        self._per_shapes: Dict[Tuple, Any] = {}

    def _ensure_jit(self):
        import jax

        if self._jit is None:
            self._jit = jax.jit(self._fun)
        return self._jit

    def lower(self, *args, **kw):  # parity with jax.jit for probes
        return self._ensure_jit().lower(*args, **kw)

    def __call__(self, *args):
        import jax

        from waveformanalysis_tpu.foundation import aot_cache

        shapes_key = tuple((tuple(a.shape), str(a.dtype)) for a in args)
        fn = self._per_shapes.get(shapes_key)
        if fn is not None:
            return fn(*args)
        dig = aot_cache.digest(self._digest_base + (shapes_key,))
        loaded = aot_cache.load(dig)
        if loaded is not None:
            exported, payload = loaded
            self._spec_cache[shapes_key] = payload
            fn = jax.jit(exported.call)
            self._per_shapes[shapes_key] = fn
            return fn(*args)
        fn = self._ensure_jit()
        self._per_shapes[shapes_key] = fn
        out = fn(*args)  # traces; fills spec_cache[shapes_key]
        payload = self._spec_cache.get(shapes_key)
        if payload is not None and aot_cache.cache_dir() is not None:
            arg_specs = tuple(
                jax.ShapeDtypeStruct(s, np.dtype(d)) for s, d in shapes_key
            )
            aot_cache.save_async(dig, fn, arg_specs, payload)
        return out


# ---------------------------------------------------------------------------
# single-transfer packing: every device->host fetch pays a fixed latency
# regardless of size, and a fused bundle has a dozen-plus output leaves.
# Bitcast/cast every leaf to int32, flatten and concatenate ON DEVICE, fetch
# once, split + cast back on host.
# ---------------------------------------------------------------------------

from waveformanalysis_tpu.ops.compact import (  # noqa: E402
    compact_slots as _compact_slots,
    decode_slot_matrix as _decode_slot_matrix,
)


# slot counts are rounded UP to this quantum before the device slice, so
# the slice+concat executable's shapes stay stable across runs (the exact
# counts are data-dependent and fresh data would otherwise force an XLA
# re-compile of the fetch program on EVERY run); the overshoot crossing the
# link is <= quantum*width*4B per member (~128 KB) — noise next to a
# per-run compile.
_FETCH_BUCKET = 4096
_fetch_programs: Dict[Tuple, Any] = {}
_remedial_programs: Dict[Tuple[int, int], Any] = {}
# last-observed per-member valid counts per fetch site (shapes + member
# set): the SPECULATIVE buckets for the next call, so counts can ride the
# head of the one packed transfer instead of a serialized round trip
_count_hints: Dict[Tuple, Tuple[int, ...]] = {}


def _round_bucket(c: int, cap: int) -> int:
    return min(cap, int(-(-int(c) // _FETCH_BUCKET) * _FETCH_BUCKET))


def _bucketed_fetch_program(buckets: Tuple[int, ...]):
    """jit counts+dense+slot-slices concat with STATIC row buckets (cached).

    The per-member valid counts ride the HEAD of the flat transfer, so the
    host learns them from the same fetch that carries the data — no
    separate count round trip."""
    prog = _fetch_programs.get(buckets)
    if prog is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def prog(counts_d, flat_d, *mats):
            parts = [counts_d.reshape(-1), flat_d.reshape(-1)]
            for mat, b in zip(mats, buckets):
                parts.append(jax.lax.slice_in_dim(
                    mat, 0, b, axis=0
                ).reshape(-1))
            return jnp.concatenate(parts)

        _fetch_programs[buckets] = prog
    return prog


def _remedial_rows(mat, lo: int, hi: int) -> np.ndarray:
    """Shape-stable fetch of rows [lo, hi) of one compact slot matrix —
    the rare make-up transfer when a speculative bucket undershot."""
    prog = _remedial_programs.get((lo, hi))
    if prog is None:
        import jax

        @jax.jit
        def prog(m):
            return jax.lax.slice_in_dim(m, lo, hi, axis=0)

        _remedial_programs[(lo, hi)] = prog
    return np.asarray(prog(mat))


def _fetch_packed_outputs(flat_d, slot_mats_d, counts_d, spec_entry,
                          hint_key=None):
    """Single-transfer host fetch of a packed fused-bundle result.

    Each compacted slot matrix is sliced to a bucket-rounded row count ON
    DEVICE and concatenated with the per-member counts and the dense flat
    array, so ONE transfer carries everything and the link moves only
    real data (plus a bounded bucket overshoot). The slice buckets must be
    static, but the true counts are data-dependent — they are predicted
    from the previous call at the same fetch site (``_count_hints``); the
    first call (no hint) pays one extra count round trip, and an
    undershoot (counts grew past the speculative bucket) triggers a small
    remedial fetch of just the missing rows. Decoded outputs are
    bit-identical in every case.

    Returns (dense_tree, {member: (rows, slots_dict)}).
    """
    dense_spec, slot_specs = spec_entry
    n_members = len(slot_specs)
    if n_members:
        caps = [int(mat.shape[0]) for mat in slot_mats_d]
        hint = _count_hints.get(hint_key) if hint_key is not None else None
        if hint is None:
            # no prediction yet: fetch the exact counts first (one round
            # trip, first call at this site only)
            hint = tuple(np.asarray(counts_d).astype(np.int64))
        buckets = tuple(
            _round_bucket(c, cap) for c, cap in zip(hint, caps)
        )
        prog = _bucketed_fetch_program(buckets)
        all_flat = np.asarray(prog(counts_d, flat_d, *slot_mats_d))
        counts = all_flat[:n_members].astype(np.int64)
        if hint_key is not None:
            _count_hints[hint_key] = tuple(int(c) for c in counts)
    else:
        buckets = ()
        counts = np.zeros((0,), np.int64)
        all_flat = np.asarray(flat_d.reshape(-1))

    dense_len = sum(
        (int(np.prod(shape)) if shape else 1) for shape, _ in dense_spec[1]
    )
    dense_tree = _unpack_host(
        all_flat[n_members:n_members + dense_len], dense_spec
    )

    slot_out = {}
    off = n_members + dense_len
    for (m, fields, dtypes), c, b, mat in zip(
        slot_specs, counts, buckets, slot_mats_d
    ):
        c = int(c)
        width = len(fields) + 1
        got = min(c, b)
        chunk = all_flat[off:off + got * width].reshape(got, width)
        off += b * width
        if c > b:  # speculative bucket undershot: fetch the missing rows
            hi = _round_bucket(c, int(mat.shape[0]))
            extra = _remedial_rows(mat, b, hi)[: c - b]
            chunk = np.concatenate([chunk, np.asarray(extra)], axis=0)
        slot_out[m] = _decode_slot_matrix(chunk, fields, dtypes)
    return dense_tree, slot_out


def _pack_leaves(tree):
    """Device-side: one flat int32 array from every leaf (inside jit)."""
    import jax
    import jax.numpy as jnp

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    metas = []
    parts = []
    for leaf in leaves:
        dt = leaf.dtype
        if dt.itemsize > 4:
            raise TypeError(
                f"packed transfer cannot carry 64-bit leaf dtype {dt}; "
                "widen the packing or keep this stage output off-bundle"
            )
        metas.append((tuple(leaf.shape), str(dt)))
        if dt == jnp.float32:
            p = jax.lax.bitcast_convert_type(leaf, jnp.int32)
        else:
            p = leaf.astype(jnp.int32)
        parts.append(p.reshape(-1))
    flat = jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.int32)
    return flat, (treedef, metas)


def _unpack_host(flat_host: np.ndarray, spec):
    treedef, metas = spec
    out = []
    off = 0
    for shape, dtype_str in metas:
        size = int(np.prod(shape)) if shape else 1
        chunk = flat_host[off:off + size]
        off += size
        if dtype_str == "float32":
            arr = chunk.view(np.float32)
        else:
            arr = chunk.astype(np.dtype(dtype_str))
        out.append(arr.reshape(shape))
    import jax

    return jax.tree_util.tree_unflatten(treedef, out)


def _packable(tree) -> bool:
    import jax
    import jax.numpy as jnp

    ok = (jnp.float32, jnp.int32, jnp.int16, jnp.int8, jnp.uint8, jnp.bool_)
    return all(
        leaf.dtype in ok for leaf in jax.tree_util.tree_leaves(tree)
    )


_DEFAULT_RULES: Optional[List[Any]] = None


def get_fusion_rules() -> List[Any]:
    global _DEFAULT_RULES
    if _DEFAULT_RULES is None:
        _DEFAULT_RULES = [WaveChainFusion()]
    return _DEFAULT_RULES
