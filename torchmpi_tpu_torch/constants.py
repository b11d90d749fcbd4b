"""Tunable communication constants with freeze semantics.

The PyTorch port's copy of ``torchmpi_tpu/constants.py``: the same knob
table behind ``get`` / ``set``, frozen by ``freeze_constants`` (the
reference's ``immutableConstants``, ``lib/constants.cpp:163-168``). Every
knob keeps its name and default so that a configuration reads the same in
both packages; the knobs that only later slices of the port consult are
carried unchanged.

Two differences from the JAX table:

- the ``_cpu`` / ``_tpu`` knob pairs gain a ``_cuda`` column, and
  :func:`platform_suffix` maps a ``cuda`` device to it. The small-message
  cutoffs of that column are the reference's GPU values
  (``lib/constants.cpp:136-141``).
- ``ring_implementation`` defaults to ``'kernel'``: on one CUDA card the
  hand-written ring kernels serve every virtual rank, so the selector's
  custom-ring choice goes to them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, fields
from typing import Any, Dict


class FrozenConstantsError(RuntimeError):
    """Raised when mutating a constant after :func:`freeze_constants`."""


@dataclass
class _Constants:
    # --- transport/routing policy (reference lib/constants.cpp:132-141) ---
    # Stage cross-slice (DCN) traffic through host memory instead of direct
    # device collectives (analog of staged-via-pinned-CPU vs GDR-direct).
    use_staged_collectives: bool = False
    # Compose collectives hierarchically (intra-slice ICI ring/reduce + inter
    # -slice exchange) instead of one flat collective over all devices.
    use_hierarchical_collectives: bool = True
    # Build cartesian communicators (equal-size intra groups linked peer-to-
    # peer) rather than tree communicators (roots only) when splitting.
    use_cartesian_communicator: bool = True
    # Let the schedule compiler race plans SYNTHESIZED from the composition
    # algebra (schedule/algebra.py: recursive halving, torus-axis rings,
    # multi-ring striping) alongside the four hand-written families.
    use_plan_synthesis: bool = False

    # --- small-message latency cutoffs, in ELEMENTS (constants.cpp:136-141) ---
    small_broadcast_size_cpu: int = 1 << 13
    small_allreduce_size_cpu: int = 1 << 16
    small_broadcast_size_tpu: int = 1 << 13
    small_allreduce_size_tpu: int = 1 << 16
    small_broadcast_size_cuda: int = 1 << 13
    small_allreduce_size_cuda: int = 1 << 16

    # --- ring chunking, in BYTES (constants.cpp:142-147) ---
    min_buffer_size_cpu: int = 1 << 17
    max_buffer_size_cpu: int = 1 << 20
    min_buffer_size_tpu: int = 1 << 17
    max_buffer_size_tpu: int = 1 << 20
    min_buffer_size_cuda: int = 1 << 17
    max_buffer_size_cuda: int = 1 << 20
    # tree -> pipelined broadcast switch-over, in bytes (constants.cpp:146-147)
    broadcast_size_tree_based_cpu: int = 1 << 22
    broadcast_size_tree_based_tpu: int = 1 << 22
    broadcast_size_tree_based_cuda: int = 1 << 22

    # --- in-flight buffering (constants.cpp:149-150, constants.h:77-78) ---
    num_buffers_per_collective_cpu: int = 3
    num_buffers_per_collective_tpu: int = 3
    num_buffers_per_collective_cuda: int = 3
    max_num_buffers_per_collective: int = 16

    # --- host-side async offload pools (constants.cpp:152-155) ---
    collective_thread_pool_size: int = 4
    parameterserver_thread_pool_size: int = 4
    num_async_collectives_in_flight: int = 1 << 20
    num_async_parameterservers_in_flight: int = 1 << 20

    # --- additions without a reference analog ---
    # Preferred backend order is handled by the selector; this picks the
    # default custom-ring implementation: 'kernel' (the hand-written CUDA
    # ring kernels, ops/ring_kernels.py), 'kernel_bidir' (the same, with
    # the kernel backend's allreduce on the bidirectional ring kernel: the
    # counterpart of 'pallas_bidir') or 'ppermute' (the point-to-point ring,
    # the 'ring' backend, collectives/primitives.py).
    ring_implementation: str = "kernel"
    # Bound on cached compiled executables per communicator (LRU evicted).
    # The reference frees per-size IPC descriptors between tester sweeps
    # (cache.lua:19-61, tester.lua:131-133); compiled XLA executables are
    # this design's per-size resource, so they get the same lifecycle:
    # bounded while live, freed wholesale by free_collective_resources/stop.
    collective_cache_max_entries: int = 256
    # Deadlock watchdog for host-side waits (parameter-server client ops):
    # seconds before a blocked wait aborts with a diagnostic. 0 disables.
    # Analog of the reference's 10s spin-acquire abort (resources.cpp:
    # 124-133), its only runtime failure detector.
    deadlock_timeout_seconds: int = 0
    # Use the native C++ runtime (csrc/libtpumpi.so) for PS shard storage,
    # handle registry, and plans when it is available; pure-Python fallback
    # otherwise (analog of the reference's optional-backend detection).
    use_native_runtime: bool = True
    # Donate input buffers to eager collectives (strict in-place semantics,
    # like the reference's inplace collective variants). Off by default:
    # JAX users expect value semantics, and donation invalidates reuse of
    # the input array.
    donate_eager_buffers: bool = False

    # --- wire format for the bandwidth-path reductions (EQuARX-style) ---
    # Default on-wire encoding for ring allreduce / reduce-scatter of
    # float32 payloads: 'full' (ship fp32 verbatim), 'bf16' (cast on
    # send, accumulate in f32), or 'int8' (block-quantized with a
    # per-block scale, f32 accumulate, requantize per hop). Opt-in
    # per-call via wire_dtype=; the autotuner measures and persists the
    # winner per (platform, world size).
    wire_dtype: str = "full"
    # Elements per quantization block (one shared scale each) for the
    # ppermute ring. The Pallas kernels always quantize per 128-lane row
    # (the sublane layout IS the block grid there); the default of 128
    # keeps both backends on the same grid.
    wire_quant_block_size: int = 128
    # Per-rank element count below which compressed wire formats are
    # bypassed: small payloads are latency-bound (op_route sends them to
    # the fused XLA path anyway) and the scale overhead erodes the win.
    wire_quant_min_elements: int = 1 << 16
    # Error-feedback compression (1-bit SGD / QSGD lineage behind
    # EQuARX): when a gradient bucket ships on a lossy wire ('int8' /
    # 'bf16'), keep the per-bucket quantization residual in an f32
    # buffer and add it back before the NEXT quantization, so the
    # compression error is fed forward instead of lost — int8 wire
    # stays convergent at scales where plain quantization drifts.
    # Residuals ride the persistent flat buckets (fusion_buffer_bytes),
    # one f32 buffer per bucket.
    wire_error_feedback: bool = False

    # --- parameter-server data path (wire format + overlap) ---
    # On-wire encoding for PS client<->server exchanges (updates, shard
    # fetches): 'full' (fp32 verbatim), 'bf16', or 'int8' (block-
    # quantized, per-block f32 scales on the wire_quant_block_size grid).
    # Server shards stay f32 master copies — decode reconstructs f32
    # before any update rule accumulates, so only the exchange is lossy
    # (the 1-bit-SGD/QSGD framing). The in-process transport honors the
    # same precision (encode->decode roundtrip), keeping single-process
    # convergence evidence faithful to the distributed deployment.
    parameterserver_wire_dtype: str = "full"
    # Chunk size (BYTES) for streaming PS shard payloads: encode of chunk
    # k+1 overlaps wire I/O of chunk k (sendmsg scatter-gather), decode
    # of chunk k overlaps the recv of chunk k+1 (recv_into, preallocated
    # buffers). 0 ships each payload as one monolithic frame.
    # tune_ps_chunk_bytes measures and persists the best value.
    ps_chunk_bytes: int = 1 << 18
    # Client-side prefetch: Update schedules (downpour/EASGD) issue the
    # next center fetch right after consuming the current one, so the
    # receive() at the next integration finds its data already in flight
    # (double-buffered per PS instance). Adds up to one send-interval of
    # staleness to the fetched center when the schedule's own `prefetch`
    # distance is 0 — the classic Downpour overlap-vs-freshness trade.
    ps_prefetch: bool = True
    # Delta-encoded fetches: receive() ships only the since-last-fetch
    # difference against a per-(shard, client) version vector; unchanged
    # shards answer with an empty 'same' frame, changed ones with a
    # delta (which int8-quantizes on far smaller scales than the full
    # tensor). Off by default: costs one shard-sized snapshot per active
    # (shard, client) pair server-side.
    parameterserver_delta_encoding: bool = False

    # --- parameter-server fabric (event-multiplexed listener) ---
    # TCP accept backlog of the PS listener socket. The event loop
    # accepts promptly, so the backlog only has to absorb connect bursts
    # (a fleet of clients starting at once); raise it for synthetic
    # fleets or mass worker restarts.
    ps_listen_backlog: int = 64
    # Admission budget: max decoded frames a listener may have admitted
    # to the apply stage (queued or applying, reply not yet sent) before
    # new UPDATE/TRIGGER frames are answered with a BUSY/retry-after
    # reply instead of being queued. The client channel retries BUSY
    # frames with jittered exponential backoff, so overload degrades to
    # bounded queue depth + retry latency instead of unbounded memory
    # growth. Control frames (barrier/gather) are always admitted.
    # 0 disables admission control.
    ps_pending_frame_budget: int = 4096
    # Base retry-after hint (milliseconds) carried on BUSY replies; the
    # client channel backs off base * 2^attempt with +-50% jitter
    # (capped at 2s) before replaying the rejected frame.
    ps_busy_retry_ms: int = 20
    # Replica-chain length per shard: each shard rank's updates are
    # chain-forwarded to the next (ps_replication - 1) distinct owner
    # processes (ack after chain-apply; fetches served by the head), so
    # one server process death no longer loses PS state — clients fail
    # over to the next live chain member (addresses already known from
    # the bootstrap exchange) and the survivor's per-(shard, client)
    # seq high-water dedups replays. 1 disables replication. Takes
    # effect for instances whose owners span >= 2 processes.
    ps_replication: int = 1
    # Seconds a chain member observed dead (ConnectionError after the
    # channel's replay budget) stays skipped by failover routing before
    # it is re-probed. Expiry bounds the split-brain window a TRANSIENT
    # stall can open: without it one client would route to the replica
    # forever while everyone else still talks to the recovered head.
    # 0 makes dead-marks permanent (until restart).
    ps_dead_peer_retry_s: float = 5.0
    # Read-path routing policy for SHARD/delta fetches against a
    # replicated shard: 'owner' fetches from the chain head (legacy
    # failover walk), 'replica' round-robins fetches across the live
    # chain members (the read-scaling mode: a read-heavy fleet spreads
    # off the owner hot spot), 'adaptive' prefers the owner until it
    # shows backpressure (a recent BUSY or an active dead-mark), then
    # spreads like 'replica' until the pressure clears. Replica-served
    # fetches carry the client's read-session floor (last-ACKED origin
    # seq minus ps_read_staleness); a member whose applied high-water
    # has not covered it answers 'stale:<hw>' and the client falls back
    # to the owner — read-your-writes holds under every policy.
    ps_read_policy: str = "owner"
    # Allowed replica lag for replica-served fetches, in ACKED origin
    # seqs per (instance, rank, client) session. 0 = strict
    # read-your-writes (a replica must have applied every update this
    # client was acked for); N > 0 trades N acked updates of session
    # staleness for replica availability. Pure readers (no acked writes)
    # are served by any live member regardless.
    ps_read_staleness: int = 0
    # Zero-copy shared-memory fetch lane: shard owners publish each
    # applied shard into a per-(instance, rank) shared-memory segment
    # (seqlock-versioned; published BEFORE the update's ack, so owner
    # shm reads are read-your-writes by construction), and co-located
    # clients map the segment and fetch without touching the socket or
    # the event loop. Torn concurrent writes are detected by the seqlock
    # and retried (bounded spins), then the fetch falls back to the
    # socket path. Off by default: costs one shard-sized segment per
    # locally-owned shard.
    ps_shm_lane: bool = False
    # Seqlock read attempts before the shm lane gives up on a torn /
    # unpublished segment and the fetch falls back to the socket path.
    ps_shm_spin_limit: int = 64

    # --- distributed flight recorder / hang watchdog ---
    # Seconds a collective dispatch or PS RPC may stay in flight (or a
    # peer's heartbeat stay stale) before the watchdog dumps a structured
    # hang report (flight recorder + spans + metrics + all-thread stacks)
    # to the telemetry dir. 0 disables. start() arms the watchdog when
    # set; `launch --watchdog-timeout N` arms it per rank via the
    # TORCHMPI_TPU_WATCHDOG env var instead (pre-start() coverage).
    watchdog_timeout_seconds: int = 0
    # Watchdog poll + heartbeat-file period, in seconds.
    watchdog_interval_seconds: int = 1

    # --- live telemetry plane (telemetry/live.py) ---
    # Export period of the per-rank live exporter: every interval one
    # bounded frame (metric-family delta, flight seq high-waters, flight
    # tail) streams to the fleet aggregator (`launch --telemetry-live`).
    # Also sets the aggregator's default staleness bound (3 intervals
    # without a frame = a stale rank).
    telemetry_live_interval_s: float = 1.0
    # Newest flight-recorder entries shipped per frame. Bounds the frame
    # size and the aggregator's per-(rank, comm) rolling window the
    # incremental desync/straggler detectors diff.
    telemetry_live_tail_entries: int = 128
    # Minimum measured dispatch samples per (op, comm, wire, payload
    # bucket, plan) key before schedule.calibrate() counts the key's
    # median as a fit point (a single noisy dispatch must not bend the
    # calibrated cost model).
    plan_calibration_min_samples: int = 3
    # Cap on Perfetto flow arrows (cross-rank causal edges: collective
    # joins and PS span->parent hops) the offline analyzer's merged
    # trace and the aggregator's /criticalpath view emit, earliest
    # first. Bounds merged-trace size on long journals; 0 removes the
    # cap.
    trace_max_flow_events: int = 512

    # --- schedule-compiler cost model (alpha-beta per link class) ---
    # Per-hop launch latency (alpha, µs) and per-MiB transfer time
    # (beta, µs/MiB) for each link class a plan step can ride: 'ici'
    # (intra-island fast fabric), 'dcn' (inter-island), 'host' (host-
    # staged device<->host<->socket hop). Plus a quantize/dequantize
    # throughput term and a per-dispatch overhead. These order candidate
    # plans analytically between measurements; tune_plan measures real
    # candidates and persists the winner per plan-cache key, which
    # overrides the analytic pick.
    plan_cost_alpha_ici_us: float = 1.0
    plan_cost_beta_ici_us_per_mib: float = 10.0
    plan_cost_alpha_dcn_us: float = 25.0
    plan_cost_beta_dcn_us_per_mib: float = 120.0
    plan_cost_alpha_host_us: float = 50.0
    plan_cost_beta_host_us_per_mib: float = 300.0
    plan_cost_quantize_us_per_mib: float = 8.0
    plan_cost_dispatch_us: float = 5.0

    # --- chunk-pipelined plan execution (schedule IR pipeline depth) ---
    # Pipeline depth policy for the ppermute-ring plan families: 0 lets
    # the (calibrated) cost model choose the depth per request among
    # power-of-two candidates; 1 pins pipelining OFF; >1 pins that depth
    # for every eligible plan. tune_pipeline_depth measures the depths
    # on the live communicator and persists the winner here (re-applied
    # by start(), like every tuned knob).
    plan_pipeline_depth: int = 0
    # Largest depth the compiler's candidate enumeration considers
    # (depths are 2, 4, ... up to this cap).
    plan_pipeline_max_depth: int = 8
    # Per-chunk LOGICAL payload floor (bytes): a depth whose chunks
    # would fall below this is not a candidate — small chunks are
    # alpha-dominated and the per-hop launch overhead eats the overlap.
    plan_pipeline_min_chunk_bytes: int = 1 << 18

    # --- gradient-overlap scheduling (bucket flush order) ---
    # How GradientBuckets / FusionBuffer order bucket flushes against
    # the backward pass: 'none' packs everything and dispatches+waits
    # each bucket serially (the all-at-once baseline), 'reverse' keeps
    # the reverse-layer bucket order (bucket 0 = last layers = first
    # gradients ready) and dispatches every bucket async before any
    # wait, so bucket k's wire time overlaps bucket k+1's quantize/pack.
    # The order is stamped into the schedule IR as per-bucket plan
    # priorities; the overlap ledger (telemetry.analyze) measures the
    # realized overlap fraction per scheduled flush.
    overlap_schedule: str = "none"

    # --- streaming input pipeline (torchmpi_tpu.data) ---
    # Bounded depth of the host-side batch ring AND the device prefetch
    # window: producer threads stay at most this many batches ahead of
    # the consumer, and the pipeline keeps the next batch's
    # host-to-device transfer in flight while the current one trains
    # (double-buffered like the PS ps_prefetch path).
    input_prefetch_batches: int = 2
    # Background producer threads assembling host batches. More than one
    # helps when per-batch assembly (decode, augment, memmap reads) is
    # the bottleneck; batches are re-sequenced by a reorder window so
    # delivery order is deterministic regardless of worker count.
    input_workers: int = 1

    # --- live elastic resharding (reshard/ subsystem) ---
    # Chunk size (BYTES) for redistribution transfers: the reshard
    # executor moves state between (world size, sharding) layouts
    # through one reusable scratch buffer of at most this many bytes,
    # so redistribution peak memory is bounded regardless of array size
    # (the "memory-efficient array redistribution" contract; asserted
    # < 2x the largest single shard in tests). 0 disables chunking
    # (one piece per transfer).
    reshard_chunk_bytes: int = 1 << 20
    # Monotone resize-epoch marker: bumped (via constants.set) every time
    # the world is resized — engine in-place resize, elastic membership
    # change, PS chain re-formation. Caches keyed on world-size-derived
    # state must re-read this knob so a resize invalidates them.
    resize_epoch: int = 0
    # Elastic membership heartbeat period, seconds: members report to
    # the resize coordinator at this cadence, and a member silent for
    # 5 heartbeats is declared dead (epoch bump -> survivors reshard).
    elastic_heartbeat_seconds: float = 0.5
    # Seconds a resize barrier may wait for the slowest member before
    # the coordinator answers it stale (members retry after the next
    # epoch). Bounds how long one wedged survivor can stall a resize;
    # the member's control RPC allows 30s of slack on top. The SAME
    # bound also caps the post-barrier redistribution wait (how long a
    # member waits for its transfer frames), so tune it to the slower
    # of barrier skew and state-transfer time.
    elastic_barrier_timeout_s: float = 300.0

    # --- recovery supervisor (supervise/ subsystem; launch --supervise) ---
    # Consecutive live-aggregation windows a streaming verdict must
    # persist before the supervisor acts on it. 1 acts on the first
    # window (no hysteresis) — a single noisy window can then evict a
    # healthy rank, so keep >= 2 in production.
    supervisor_hysteresis_windows: int = 3
    # Bounded attempts per escalation-ladder rung: after this many
    # failed/uncleared attempts of a verdict's primary action, the
    # supervisor escalates (evict -> checkpoint rollback) or holds.
    supervisor_max_retries: int = 3
    # Jittered exponential backoff between attempts of one rung:
    # base * 2^attempt seconds, +-50% seeded jitter, capped below.
    supervisor_backoff_base_s: float = 1.0
    supervisor_backoff_cap_s: float = 30.0
    # Seconds a quarantined (straggler-evicted) rank stays on the
    # rejoin denylist; grow-back will not re-admit capacity while the
    # denylist covers it.
    supervisor_quarantine_cooldown_s: float = 60.0
    # Opt-in grow-back rung: once the fleet has been clean for the
    # hysteresis window and the world is below its observed high-water
    # (minus quarantined ranks), request an elastic grow. Off by
    # default: shrink-and-continue is the conservative posture.
    supervisor_grow_back: bool = False
    # Consecutive overloaded windows before the scale-up rung fires
    # (the load analog of supervisor_hysteresis_windows; scale-up reacts
    # faster than scale-down on purpose: adding capacity is cheap to
    # undo, shedding users is not).
    supervisor_scale_up_hysteresis: int = 3
    # Consecutive underloaded windows before the scale-down rung
    # retires the highest rank. Keep well above the scale-up hysteresis:
    # asymmetric thresholds are the first line of flap damping.
    supervisor_scale_down_hysteresis: int = 8
    # Minimum seconds between ANY two applied scale actions (up or
    # down): the second line of flap damping. An oscillating arrival
    # trace can satisfy both hysteresis counters in turn; the cooldown
    # bounds the resize rate regardless.
    supervisor_scale_cooldown_s: float = 30.0
    # Hard ceiling on the world size the scale-up rung will request
    # (0 = unbounded). At the ceiling the supervisor holds and the
    # serving tier's brownout ladder degrades instead of collapsing.
    supervisor_scale_max_world: int = 0
    # Floor below which scale-down never shrinks the world.
    supervisor_scale_min_world: int = 1

    # --- fleet simulation (torchmpi_tpu.sim: modeled network, real
    # --- control plane; see README "Fleet simulation") ---
    # Modeled wall-clock period of one training step in the simulated
    # fleet (compute + dispatch; the collective itself is priced by the
    # plan cost model on top).
    sim_step_seconds: float = 0.25
    # Fractional latency jitter the modeled network draws per event
    # (uniform in [1-j, 1+j], from the scenario's seeded RNG): 0 makes
    # every latency exactly the cost-model value.
    sim_jitter_pct: float = 0.05
    # Modeled member<->coordinator control round trip (µs) for joins,
    # barrier arrivals and view fetches in the simulated fleet.
    sim_control_rtt_us: float = 500.0

    # --- serving tier (torchmpi_tpu.serve; README "Serving & autoscaling") ---
    # Per-server cap on queued inference requests before the local
    # brownout ladder engages (distinct from ps_pending_frame_budget,
    # which is the transport-level admission budget shared with
    # training traffic).
    serve_queue_budget: int = 256
    # Service-level objective on per-request latency, milliseconds.
    # Replies slower than this count as SLO breaches; the load verdict's
    # burn rate is breaches/requests per aggregation window.
    serve_slo_ms: float = 50.0
    # Number of QoS levels carried on REQUEST frames (0 = lowest).
    # Brownout shedding drops the lowest level first.
    serve_qos_levels: int = 3
    # Retry-after hint (ms) carried on shed replies, mirroring
    # ps_busy_retry_ms for BUSY frames.
    serve_shed_retry_ms: int = 50
    # Seconds between background weight-refresh fetches (the
    # delta-fetch path); each fetch that lands a newer version swaps
    # the serving weights atomically.
    serve_refresh_interval_s: float = 2.0
    # Read-routing policy for the background weight refresher's fetches
    # ('' inherits ps_read_policy). Default 'replica': a serving tier's
    # weight refreshes spread across the replica chain instead of
    # competing with training updates at the shard owner; freshness is
    # preserved by the read-session staleness bound + the version-vector
    # swap (a stale-identical fetch is a no-op swap, never a regression).
    serve_refresh_read_policy: str = "replica"
    # Staleness bound: a server whose weights are older than this warns
    # (and the brownout ladder may widen it; see the factor below).
    serve_refresh_staleness_s: float = 30.0
    # Brownout level 2 multiplies both the refresh interval and the
    # staleness bound by this factor: under pressure, serving slightly
    # staler weights beats missing the latency SLO.
    serve_brownout_staleness_factor: float = 4.0
    # Load-verdict thresholds (FleetAggregator): fraction of a window's
    # requests that breached the SLO before the window counts as
    # overloaded...
    serve_slo_burn_threshold: float = 0.1
    # ...or fleet-wide BUSY/shed rejects per second per rank...
    serve_overload_busy_rate: float = 1.0
    # ...or sustained queue growth per second per rank (trend, not
    # level: a full-but-draining queue is not overload).
    serve_queue_growth_per_s: float = 1.0
    # Underload: fleet-wide requests per second per rank below which a
    # window counts toward scale-down (with zero breaches/rejects).
    serve_underload_qps: float = 1.0

    # --- coalescing dispatch (latency path; GC3-style fused plans) ---
    # Capacity of the flat fusion buffer: pending same-(op, dtype, comm,
    # wire) async collectives pack into one contiguous buffer and flush
    # as a SINGLE collective when the per-rank payload reaches this many
    # bytes (or on wait()/sync_all()). 0 disables coalescing entirely —
    # every submit dispatches immediately, the pre-fusion behavior.
    fusion_buffer_bytes: int = 4 << 20
    # Minimum pending tensors for a flush to dispatch FUSED: below this,
    # packing overhead (the gather executable) exceeds the saved
    # dispatches, so the flush falls back to one collective per tensor.
    fusion_min_tensors: int = 2


_frozen = False
_lock = threading.Lock()
_values = _Constants()

_FIELD_NAMES = {f.name for f in fields(_Constants)}


def platform_suffix(platform: str) -> str:
    """Map a device type (``torch.device.type``) to the cutoff-constant
    suffix (the reference's CPU/GPU constant pairs): 'cpu' and 'cuda'
    keep their own column, any other accelerator takes 'tpu'."""
    return platform if platform in ("cpu", "cuda") else "tpu"


def get(name: str) -> Any:
    if name not in _FIELD_NAMES:
        raise KeyError(f"unknown constant: {name}")
    return getattr(_values, name)


def set(name: str, value: Any) -> None:  # noqa: A001 - parity with C setters
    if name not in _FIELD_NAMES:
        raise KeyError(f"unknown constant: {name}")
    with _lock:
        if _frozen:
            raise FrozenConstantsError(
                f"constants are frozen; cannot set {name!r} (freeze_constants "
                "was called, matching the reference immutableConstants check)"
            )
        current = getattr(_values, name)
        # bool is a subclass of int: require the bool-ness of value and field
        # to match exactly, then ordinary type compatibility.
        if isinstance(current, bool) != isinstance(value, bool) or not isinstance(
            value, type(current)
        ):
            raise TypeError(
                f"constant {name!r} expects {type(current).__name__}, "
                f"got {type(value).__name__}"
            )
        setattr(_values, name, value)


def freeze_constants() -> None:
    """Permanently freeze the table (reference ``lib/constants.cpp:130,163``)."""
    global _frozen
    with _lock:
        _frozen = True


def constants_frozen() -> bool:
    return _frozen


def snapshot() -> Dict[str, Any]:
    """A plain-dict view of every constant (for introspection dumps)."""
    return {f.name: getattr(_values, f.name) for f in fields(_Constants)}


def _reset_for_tests() -> None:
    """Unfreeze and restore defaults. Test-only."""
    global _frozen, _values
    with _lock:
        _frozen = False
        _values = _Constants()


def __getattr__(name: str):
    # Allow `constants.small_allreduce_size_tpu` style reads.
    if name in _FIELD_NAMES:
        return getattr(_values, name)
    raise AttributeError(name)
