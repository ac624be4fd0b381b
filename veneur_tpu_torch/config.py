"""Configuration of the port's server and proxy.

A YAML file (the veneur key names) maps onto :class:`Config`, and a
proxy's onto :class:`ProxyConfig` (:func:`read_proxy_config`). Both hold
every key of the JAX package's, with its defaults and deprecations
(``example.yaml`` loads field for field equal); a key neither knows
raises :class:`UnsupportedConfig` instead of being ignored (the JAX
package warns), unless its value is empty or off (``""``, ``[]``,
``false``, ``null``). PyYAML is imported only inside the readers: code
that builds its config directly never needs it. The gRPC keys
(``forward_use_grpc``, ``grpc_address``, ``falconer_address``, a
proxy's ``grpc_forward_address``) need grpcio: without it they raise
:class:`UnsupportedConfig`, never a quiet fall back to HTTP.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import socket
from dataclasses import dataclass, field
from typing import Dict, List

from veneur_tpu_torch import overload
from veneur_tpu_torch.resilience import compute, faults

log = logging.getLogger("veneur.config")

class UnsupportedConfig(ValueError):
    """A configuration key or value this port does not implement yet."""


_BREAKER_THRESHOLD_DEFAULT = 5
_STATSD_SCHEMES = tuple(f"{s}://" for s in ("udp", "udp4", "udp6", "tcp",
                                             "tcp4", "tcp6"))
_SSF_SCHEMES = _STATSD_SCHEMES + ("unix://",)
# the deprecated LightStep spellings and the keys they fill
_LIGHTSTEP_RENAMES = tuple(
    (f"trace_lightstep_{k}", f"lightstep_{k}")
    for k in ("access_token", "collector_host", "maximum_spans",
              "num_clients", "reconnect_period"))


def require_grpc(key: str) -> None:
    """Raise UnsupportedConfig unless grpcio imports: a gRPC key never
    falls back to another transport."""
    try:
        import grpc  # noqa: F401
    except ImportError as e:
        raise UnsupportedConfig(
            f"{key} needs grpcio, which does not import here ({e}); "
            f"install grpcio or forward over http:// or native://") from e


def _check_fault_kinds(cfg) -> None:
    """The ``fault_injection_*`` keys: the rate in [0, 1] and known
    kinds. Every kind has its hook in the port, so a Server and a proxy
    admit every known kind, as the JAX package does."""
    if not 0.0 <= cfg.fault_injection_rate <= 1.0:
        raise ValueError(f"fault_injection_rate must be in [0, 1], got "
                         f"{cfg.fault_injection_rate}")
    kinds = [k.strip() for k in cfg.fault_injection_kinds.split(",")
             if k.strip()]
    bad = [k for k in kinds if k not in faults.KNOWN_KINDS]
    if bad:
        raise ValueError(f"unknown fault_injection_kinds {bad}; known: "
                         f"{list(faults.KNOWN_KINDS)}")


@dataclass
class Config:
    """Server configuration (config.go:3-89); field names are YAML keys."""

    statsd_listen_addresses: List[str] = field(default_factory=list)
    interval: str = "10s"
    percentiles: List[float] = field(default_factory=list)
    aggregates: List[str] = field(default_factory=list)
    tdigest_compression: float = 100.0
    hll_precision: int = 14
    hostname: str = ""
    tags: List[str] = field(default_factory=list)
    debug: bool = False
    debug_flushed_metrics: bool = False
    num_readers: int = 1
    metric_max_length: int = 4096
    read_buffer_size_bytes: int = 2 * 1048576
    # drain plain-IPv4 UDP statsd listeners with the C++ recvmmsg reader
    # pool and batch parser when the native library builds (used only
    # with ingest_lanes: -1)
    native_ingest: bool = True
    # the ingest-lane fleet for UDP statsd listeners (ingest/): each
    # reader thread owns a lock-free lane (SO_REUSEPORT socket, recvmmsg
    # batches, native parse, lane-local interning and columnar staging)
    # merged into the store one chunk at a time. 0 = one lane per reader
    # (num_readers); N > 0 = N lanes; -1 = off (the C++ reader pool, else
    # the Python readers)
    ingest_lanes: int = 0
    # global aggregation: a local forwards to forward_address (http://,
    # native://host:port, the framed-TCP MetricList lane, or host:port
    # with forward_use_grpc); a global serves POST /import (and
    # /healthcheck, /version) on http_address, the framed-TCP import on
    # native_import_address and Forward.SendMetrics on grpc_address
    forward_address: str = ""
    http_address: str = ""
    native_import_address: str = ""
    grpc_address: str = ""
    # per-flush forward budget: retries never push a forward past it
    forward_timeout: str = ""
    # forward in the reference's JSONMetric format (gob digests, axiomhq
    # sets), for a Go global
    forward_reference_compatible: bool = False
    # forward over gRPC (Forward.SendMetrics; forward_address is the
    # global's or a proxy's host:port); needs grpcio
    forward_use_grpc: bool = False
    # native:// and gRPC forwarding ship device-packed digests (u16
    # means, bfloat16 weights: tdigest fields 16/17); false keeps the
    # dense float64 wire a global without those fields reads (HTTP
    # ignores it)
    forward_packed_digests: bool = True
    # RE-tries per forward (0 = one attempt; -1 = unset, defaults to 2)
    retry_max: int = -1
    # first backoff; later retries double it with full jitter
    retry_base_interval: str = ""
    # consecutive failures before the forward breaker opens (0 = 5)
    breaker_failure_threshold: int = 0
    # how long an open breaker waits before a half-open probe
    breaker_reset_timeout: str = ""
    # SSF: udp:// (one bare SSFSpan a datagram; the C++ reader pool when
    # native_ingest is on), unix:// and tcp:// (framed spans) listeners
    ssf_listen_addresses: List[str] = field(default_factory=list)
    # threads draining the span channel into the span sinks (0 = 1)
    num_span_workers: int = 0
    # spans (or native span batches) queued for the span workers; a full
    # channel sheds and counts (0 = 100; negative refused)
    span_channel_capacity: int = 0
    # the largest SSF datagram read (0 = 16 KiB)
    trace_max_length_bytes: int = 0
    # name of the duration timer an indicator span yields ("" = none)
    indicator_span_timer_name: str = ""
    # leave the hostname empty instead of defaulting it to the host's
    omit_empty_hostname: bool = False
    # align the flush ticker to wall-clock multiples of the interval
    synchronize_with_interval: bool = False
    # the store's staging chunk (samples a device drain takes) and each
    # group's initial row capacity
    store_chunk: int = 16384
    store_initial_capacity: int = 4096
    # histogram/timer digest storage: "dense" (one [S, K] plane a field),
    # "slab" (flat per-slab planes, grown a slab at a time: the
    # multi-million-series plan, core/slab.py) or "tiered" (every series
    # in a packed u16/bfloat16 pool at ~228 B a row, dense full-K slots
    # for series with sustained activity: core/tiered.py)
    digest_storage: str = "dense"
    # tiered: packed-pool centroid slots a series (a power of two >= 8)
    tier_pool_centroids: int = 16
    # tiered: interval samples at or above which a series is HOT (0 =
    # 64); a hot pool series takes a dense slot mid-interval once its
    # hot streak reaches tier_promote_intervals
    tier_promote_samples: int = 0
    # tiered: hot intervals in a row before a dense slot (0 = 2)
    tier_promote_intervals: int = 0
    # tiered: idle intervals in a row after which a dense series goes
    # back to the pool at a flush boundary (0 = 3)
    tier_demote_intervals: int = 0
    # slab: the digest planes' storage type, "float32" or "bfloat16"
    # (half the memory; the kernels and the counts stay float32)
    digest_dtype: str = "float32"
    # slab: rows a slab (at most 1,048,576: the per-slab flush transient
    # scales with it); tiered pool slabs take at most 262,144
    slab_rows: int = 1 << 20
    # shard the global-tier store over a (series, hosts) mesh
    # (core/mesh_store.py); only meaningful on a global instance
    # (forward_address unset); dense digest storage, or tiered (the mesh
    # tiered store, fleet/mesh_tiered.py)
    mesh_enabled: bool = False
    # mesh fan-in axis width (0 = auto: 2 when the device count is even)
    mesh_hosts: int = 0
    # the global's import pool: merge threads and queued bodies
    http_import_workers: int = 2
    http_import_queue: int = 64
    # heavy-hitter (veneurtopk) count-min geometry and top-k size
    topk_depth: int = 4
    topk_width: int = 1 << 16
    topk_k: int = 32
    # per-scope-class series cap, INCLUDING the one overflow row: past
    # it first-sight series collapse into veneur.overload.overflow
    # (0 = 1,048,576; negative refused)
    max_series: int = 0
    # joined-tag length cap a series; longer tag sets are cut at a tag
    # boundary and counted as oversized_tags (0 = 1024; negative refused)
    max_tag_length: int = 0
    # admission watermarks over the pressure signal: >= low freezes
    # first-sight series, >= high sheds spans, >= hard sheds statsd at
    # the socket (0 = 0.7 / 0.85 / 0.97; 0 < low < high < hard <= 1)
    overload_low_watermark: float = 0.0
    overload_high_watermark: float = 0.0
    overload_hard_watermark: float = 0.0
    # columnar flush egress: counters, gauges, set estimates and digest
    # aggregates stay flat arrays from the store through the native
    # serializer (native/egress.py); a library that cannot build fails
    # the flush instead of falling back (false = per-row emission)
    flush_columnar: bool = True
    # overlapped flush: every group's program dispatches before any
    # blocking fetch, one serializer thread emits while the next fetch
    # blocks, at most this many fetched results resident (0 = each
    # group drained in turn; negative refused)
    flush_pipeline_depth: int = 2
    # streaming egress: chunk-capable sinks (and the HTTP forwarder) POST
    # each completed group as it exists; needs flush_columnar and
    # flush_pipeline_depth > 0
    flush_streaming: bool = True
    # bytes of unacked streamed sink bodies parked for a retry next
    # interval; past it the oldest drop, counted (0 = 32 MiB; negative
    # refused)
    sink_requeue_max_bytes: int = 0
    # the Datadog metric sink: built when both are set
    datadog_api_hostname: str = ""
    datadog_api_key: str = ""
    # series a Datadog body holds at most (0 = 25,000)
    datadog_flush_max_per_body: int = 0
    # deprecated spelling of datadog_flush_max_per_body
    flush_max_per_body: int = 0
    # the local-file plugin: a gzip TSV member appended each flush
    flush_file: str = ""
    # crash-safe state (persist/): where the interval checkpoint lives
    # ("" = no checkpoints; the atomic write's scratch file is
    # checkpoint_path + ".tmp"), how often it is written (the bound on
    # data lost to a crash; "" = interval / 4), and the age, in flush
    # intervals, past which a checkpoint found at startup is stale and
    # discarded (0 = 2.0)
    checkpoint_path: str = ""
    checkpoint_interval: str = ""
    checkpoint_max_age_intervals: float = 0.0
    # the flush kernel's compute breaker (resilience/compute.py):
    # consecutive kernel failures before flushes and drains take the
    # plain version (0 = 2), and how long an open breaker waits before
    # one flush probes the kernel again ("" = 60s)
    compute_breaker_failure_threshold: int = 0
    compute_breaker_reset_timeout: str = ""
    # seeded fault injection (resilience/faults.py; rate 0 = off): the
    # same seed gives the same schedule. The port arms disk_full (the
    # checkpoint commit) and deadline_pressure (the flush's egress
    # budget); scope substring-filters the operation names
    fault_injection_rate: float = 0.0
    fault_injection_seed: int = 0
    fault_injection_kinds: str = ""
    fault_injection_scope: str = ""
    # elastic resharding of the global tier (fleet/handoff.py): on a
    # change of the fleet's membership the moved key ranges stream as
    # packed digests to their new owner's POST /handoff. A global only;
    # needs handoff_self (this instance's address as the membership
    # source reports it), a membership source (handoff_peers: comma-
    # separated addresses or "file:///path", one a line, re-read each
    # refresh; else the Consul service handoff_service_name, default
    # veneur-global) and http_address. The refresh cadence ("" = 10s)
    # and a handoff POST's budget, retries included ("" =
    # forward_timeout)
    handoff_enabled: bool = False
    handoff_self: str = ""
    handoff_peers: str = ""
    handoff_service_name: str = ""
    handoff_refresh_interval: str = ""
    handoff_timeout: str = ""
    # global HA (fleet/standby.py): the standbys the active replicates
    # each flush's retired snapshot to (POST /replicate; comma-separated
    # or "file:///path" re-read each dispatch; "" = none, needs
    # http_address), the replicated epochs a standby keeps a sender (0 =
    # 2), and the leadership lease (discovery/lease.py): "file:///path"
    # or "consul://key" ("" = no election: an instance with
    # standby_peers replicates unconditionally), its ttl ("" = 15s: the
    # bound on detecting an active's death) and its renew cadence ("" =
    # lease_ttl / 3). A global only
    standby_peers: str = ""
    standby_shadow_epochs: int = 0
    lease_path: str = ""
    lease_ttl: str = ""
    lease_renew_interval: str = ""
    # the flush's self-trace (obs/, trace/): each flush runs under a
    # StageRecorder and a veneur.flush span whose samples (the veneur.*
    # self-metrics) and stage durations (the self_timers group)
    # re-enter this server's own pipeline; GET /debug/flush-timeline
    # serves the last obs_timeline_intervals stage trees (0 = 64;
    # negative refused). Off: no recorder, no ring, no lane stage
    # timers; the kernel scopes' dispatch counters stay on
    obs_enabled: bool = True
    obs_timeline_intervals: int = 0
    # where the reference sends its own statsd metrics; accepted and not
    # read, as in the JAX package (the self-metrics ride the flush span)
    stats_address: str = ""
    # the fleet trace plane (obs/fleet.py): the peers whose
    # /debug/flush-timeline and /debug/vars GET /debug/fleet pulls, a
    # CSV of addresses or "file:///path" re-read each refresh (one a
    # line); empty = handoff_peers, else this instance's own entries
    # only. List the locals too: the stitched trace needs their flushes
    fleet_peers: str = ""
    # least seconds between two peer-pull rounds ("" = 5s) and one
    # peer's HTTP budget a pull ("" = 2s)
    fleet_pull_interval: str = ""
    fleet_pull_timeout: str = ""
    # crash reports (crash.py): a Sentry DSN every Server thread reports
    # an uncaught exception to before it rethrows; malformed raises here
    sentry_dsn: str = ""
    # cProfile from start to shutdown, written to veneur-profile.pstats
    enable_profiling: bool = False
    # Go-runtime profile knobs: accepted for the reference's files and
    # refused when set (nothing here would read them)
    block_profile_rate: int = 0
    mutex_profile_fraction: int = 0
    # the reference's worker count (0 = 1); the store has no workers
    num_workers: int = 0
    # a tcp:// statsd listener serves TLS with both of these set, and
    # requires a client certificate signed by the authority when it is
    # set (the C++ listener with native_ingest, else the Python one)
    tls_certificate: str = ""
    tls_key: str = ""
    tls_authority_certificate: str = ""
    # tag keys the SignalFx sink drops from every datapoint
    tags_exclude: List[str] = field(default_factory=list)
    # a debug span sink printing each span
    debug_ingested_spans: bool = False
    # the SignalFx metric sink (sinks/signalfx.py): built when the key
    # and the endpoint are set; the host's dimension name ("" = host),
    # and a tag whose value picks a per-tag API key ({name, api_key}
    # maps)
    signalfx_api_key: str = ""
    signalfx_endpoint_base: str = ""
    signalfx_hostname_tag: str = ""
    signalfx_vary_key_by: str = ""
    signalfx_per_tag_api_keys: List[Dict[str, str]] = field(
        default_factory=list)
    # the Datadog span sink: the trace agent's address and the ring of
    # spans it keeps between flushes (0 = 16,384)
    datadog_trace_api_address: str = ""
    datadog_span_buffer_size: int = 0
    # deprecated spelling of datadog_span_buffer_size
    ssf_buffer_size: int = 0
    # the Kafka sinks (sinks/kafka.py, over sinks/kafka_wire.py): a
    # metric sink with kafka_metric_topic, a span sink with
    # kafka_span_topic; acks all|none|local, the hash|random partitioner
    kafka_broker: str = ""
    kafka_metric_topic: str = ""
    kafka_check_topic: str = ""
    kafka_event_topic: str = ""
    kafka_span_topic: str = ""
    kafka_partitioner: str = ""
    kafka_metric_require_acks: str = ""
    kafka_span_require_acks: str = ""
    kafka_retry_max: int = 0
    kafka_metric_buffer_bytes: int = 0
    kafka_metric_buffer_messages: int = 0
    kafka_metric_buffer_frequency: str = ""
    kafka_span_buffer_bytes: int = 0
    kafka_span_buffer_mesages: int = 0  # (sic: the reference's key)
    kafka_span_buffer_frequency: str = ""
    kafka_span_sample_rate_percent: int = 0
    kafka_span_sample_tag: str = ""
    kafka_span_serialization_format: str = ""
    # the LightStep span sink (sinks/lightstep.py)
    lightstep_access_token: str = ""
    lightstep_collector_host: str = ""
    lightstep_maximum_spans: int = 0
    lightstep_num_clients: int = 0
    lightstep_reconnect_period: str = ""
    # deprecated spellings of the lightstep_* keys
    trace_lightstep_access_token: str = ""
    trace_lightstep_collector_host: str = ""
    trace_lightstep_maximum_spans: int = 0
    trace_lightstep_num_clients: int = 0
    trace_lightstep_reconnect_period: str = ""
    # the Falconer span sink: a gRPC SpanSink service's host:port
    falconer_address: str = ""
    # the S3 archive plugin (plugins/s3.py): built with the bucket; it
    # stays off without an S3 client (boto3)
    aws_access_key_id: str = ""
    aws_secret_access_key: str = ""
    aws_region: str = ""
    aws_s3_bucket: str = ""

    def __post_init__(self):
        if not self.aggregates:
            self.aggregates = ["min", "max", "count"]
        if not self.hostname and not self.omit_empty_hostname:
            self.hostname = socket.gethostname()
        for spec in self.statsd_listen_addresses:
            if not spec.startswith(_STATSD_SCHEMES):
                raise UnsupportedConfig(
                    f"statsd_listen_addresses: {spec!r} is not a udp:// "
                    "or tcp:// address")
        for key in ("forward_use_grpc", "grpc_address", "falconer_address"):
            if getattr(self, key):
                require_grpc(key)
        for key in ("block_profile_rate", "mutex_profile_fraction"):
            if getattr(self, key):
                raise ValueError(
                    f"{key} is a Go-runtime profile knob with no "
                    f"equivalent here; remove it (enable_profiling drives "
                    f"the Python profiler)")
        self._apply_sink_defaults()
        for spec in self.ssf_listen_addresses:
            if not spec.startswith(_SSF_SCHEMES):
                raise UnsupportedConfig(
                    f"ssf_listen_addresses: {spec!r} is not a udp://, "
                    "tcp:// or unix:// address")
        if self.obs_timeline_intervals < 0:
            raise ValueError(
                f"obs_timeline_intervals must be >= 0 (0 = use the "
                f"default, 64; the ring cannot be unbounded), got "
                f"{self.obs_timeline_intervals}")
        self.obs_timeline_intervals = self.obs_timeline_intervals or 64
        if self.span_channel_capacity < 0:
            # queue.Queue treats maxsize <= 0 as unbounded, which would
            # defeat span shedding; 0 takes the default
            raise ValueError(
                f"span_channel_capacity must be positive (0 = use the "
                f"default, 100; a queue.Queue maxsize <= 0 is unbounded "
                f"and defeats span shedding), got "
                f"{self.span_channel_capacity}")
        if self.max_series < 0:
            raise ValueError(
                f"max_series must be positive (0 = use the default, "
                f"{overload.DEFAULT_MAX_SERIES}; an unbounded store fails "
                f"open under a cardinality flood), got {self.max_series}")
        if self.max_tag_length < 0:
            raise ValueError(
                f"max_tag_length must be positive (0 = use the default, "
                f"{overload.DEFAULT_MAX_TAG_LENGTH}), got "
                f"{self.max_tag_length}")
        self.max_series = self.max_series or overload.DEFAULT_MAX_SERIES
        self.max_tag_length = (self.max_tag_length
                               or overload.DEFAULT_MAX_TAG_LENGTH)
        self.overload_low_watermark = (self.overload_low_watermark
                                       or overload.DEFAULT_LOW_WATERMARK)
        self.overload_high_watermark = (self.overload_high_watermark
                                        or overload.DEFAULT_HIGH_WATERMARK)
        self.overload_hard_watermark = (self.overload_hard_watermark
                                        or overload.DEFAULT_HARD_WATERMARK)
        marks = (self.overload_low_watermark, self.overload_high_watermark,
                 self.overload_hard_watermark)
        if not 0.0 < marks[0] < marks[1] < marks[2] <= 1.0:
            raise ValueError(
                f"overload watermarks must satisfy 0 < low < high < "
                f"hard <= 1 (after 0-means-default substitution), got "
                f"{marks[0]}/{marks[1]}/{marks[2]}")
        self.span_channel_capacity = self.span_channel_capacity or 100
        self.num_span_workers = self.num_span_workers or 1
        self.trace_max_length_bytes = self.trace_max_length_bytes or 16384
        if self.ingest_lanes < -1:
            raise ValueError(
                f"ingest_lanes must be -1 (disabled), 0 (auto: one lane "
                f"per reader) or a positive lane count, got "
                f"{self.ingest_lanes}")
        # defaults and validation of veneur_tpu/config.py's egress knobs
        if self.breaker_failure_threshold < 0:
            raise ValueError(
                f"breaker_failure_threshold must be >= 0 (0 = use the "
                f"default, {_BREAKER_THRESHOLD_DEFAULT}), got "
                f"{self.breaker_failure_threshold}")
        if not self.breaker_failure_threshold:
            self.breaker_failure_threshold = _BREAKER_THRESHOLD_DEFAULT
        if self.retry_max < 0:
            self.retry_max = 2
        if self.flush_pipeline_depth < 0:
            raise ValueError(
                f"flush_pipeline_depth must be >= 0 (0 = sequential "
                f"flush, N = overlapped pipeline bounded at N in-flight "
                f"chunks), got {self.flush_pipeline_depth}")
        if self.sink_requeue_max_bytes < 0:
            raise ValueError(
                f"sink_requeue_max_bytes must be >= 0 (0 = use the "
                f"default, 32 MiB; the parked-body budget cannot be "
                f"unbounded), got {self.sink_requeue_max_bytes}")
        self.sink_requeue_max_bytes = (self.sink_requeue_max_bytes
                                       or 32 * 1048576)
        if self.flush_max_per_body:
            log.warning("flush_max_per_body has been replaced by "
                        "datadog_flush_max_per_body and will be removed")
            if not self.datadog_flush_max_per_body:
                self.datadog_flush_max_per_body = self.flush_max_per_body
        self.datadog_flush_max_per_body = (self.datadog_flush_max_per_body
                                           or 25000)
        if self.checkpoint_max_age_intervals < 0:
            raise ValueError(
                f"checkpoint_max_age_intervals must be >= 0 (0 = use the "
                f"default, 2.0), got {self.checkpoint_max_age_intervals}")
        self.checkpoint_max_age_intervals = (
            self.checkpoint_max_age_intervals or 2.0)
        if self.compute_breaker_failure_threshold < 0:
            raise ValueError(
                f"compute_breaker_failure_threshold must be >= 0 (0 = use "
                f"the default, {compute.DEFAULT_FAILURE_THRESHOLD}; the "
                f"compute breaker cannot be disabled), got "
                f"{self.compute_breaker_failure_threshold}")
        self.compute_breaker_failure_threshold = (
            self.compute_breaker_failure_threshold
            or compute.DEFAULT_FAILURE_THRESHOLD)
        self.compute_breaker_reset_timeout = (
            self.compute_breaker_reset_timeout or "60s")
        _check_fault_kinds(self)
        if self.digest_storage not in ("dense", "slab", "tiered"):
            raise ValueError(
                f"digest_storage must be 'dense', 'slab' or 'tiered', "
                f"got {self.digest_storage!r}")
        pk = self.tier_pool_centroids
        if pk < 8 or pk & (pk - 1):
            raise ValueError(
                f"tier_pool_centroids must be a power of two >= 8 (the "
                f"packed pool's per-row centroid budget), got {pk}")
        for knob in ("tier_promote_samples", "tier_promote_intervals",
                     "tier_demote_intervals"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob} must be >= 0 (0 = use the default), "
                    f"got {getattr(self, knob)}")
        if self.digest_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"digest_dtype must be 'float32' or 'bfloat16', got "
                f"{self.digest_dtype!r}")
        if self.digest_dtype == "bfloat16" and self.digest_storage != "slab":
            raise ValueError(
                "digest_dtype: bfloat16 requires digest_storage: slab "
                "(the dense store is f32-only)")
        if self.slab_rows <= 0:
            raise ValueError(f"slab_rows must be positive, got "
                             f"{self.slab_rows}")
        if self.digest_storage == "slab" and self.mesh_enabled:
            raise ValueError(
                "digest_storage: slab cannot combine with mesh_enabled: "
                "the slab layout is the single-card capacity plan and "
                "fleet mode supersedes it; run the mesh dense")
        if self.mesh_enabled and self.forward_address:
            raise ValueError(
                "mesh_enabled requires a GLOBAL instance, but "
                "forward_address is set (a local forwards its sketches "
                "upstream instead of sharding a store over the mesh). "
                "Unset one of them: mesh_enabled belongs on the "
                "instance the fleet forwards INTO")
        if self.mesh_hosts < 0:
            raise ValueError(f"mesh_hosts must be >= 0 (0 = auto), got "
                             f"{self.mesh_hosts}")
        self.tier_promote_samples = self.tier_promote_samples or 64
        self.tier_promote_intervals = self.tier_promote_intervals or 2
        self.tier_demote_intervals = self.tier_demote_intervals or 3
        self.forward_timeout = self.forward_timeout or "10s"
        self.retry_base_interval = self.retry_base_interval or "100ms"
        self.breaker_reset_timeout = self.breaker_reset_timeout or "30s"
        for name in ("interval", "forward_timeout", "retry_base_interval",
                     "breaker_reset_timeout",
                     "compute_breaker_reset_timeout"):
            parse_duration(getattr(self, name))  # malformed raises here
        if self.checkpoint_interval:
            parse_duration(self.checkpoint_interval)
        self._check_fleet_keys()

    def _apply_sink_defaults(self):
        """The sink keys' deprecation shims and defaults (the JAX
        ``apply_defaults``), and their durations checked."""
        if self.ssf_buffer_size:
            log.warning("ssf_buffer_size has been replaced by "
                        "datadog_span_buffer_size and will be removed")
            if not self.datadog_span_buffer_size:
                self.datadog_span_buffer_size = self.ssf_buffer_size
        for old, new in _LIGHTSTEP_RENAMES:
            if getattr(self, old):
                log.warning("%s has been replaced by %s and will be "
                            "removed", old, new)
                if not getattr(self, new):
                    setattr(self, new, getattr(self, old))
        self.datadog_span_buffer_size = self.datadog_span_buffer_size or 16384
        self.num_workers = self.num_workers or 1
        for name in ("lightstep_reconnect_period",
                     "kafka_metric_buffer_frequency",
                     "kafka_span_buffer_frequency"):
            if getattr(self, name):
                parse_duration(getattr(self, name))  # malformed raises

    def _check_fleet_keys(self):
        """The handoff, standby and lease keys (JAX ``config.py``
        ``validate``): a global only, each with what it needs."""
        if self.handoff_enabled:
            if self.forward_address:
                raise ValueError(
                    "handoff_enabled requires a GLOBAL instance, but "
                    "forward_address is set (a local owns no ring "
                    "ranges to hand off). Unset one of them")
            if not self.handoff_self:
                raise ValueError(
                    "handoff_enabled requires handoff_self: the address "
                    "this instance appears as in the fleet membership "
                    "(handoff_peers / discovery)")
            if not self.handoff_peers and not self.handoff_service_name:
                raise ValueError(
                    "handoff_enabled requires a membership source: set "
                    "handoff_peers (static CSV or file://...) or "
                    "handoff_service_name (Consul)")
            if not self.http_address:
                raise ValueError(
                    "handoff_enabled requires http_address: peers "
                    "stream moved ranges into POST /handoff on it")
        if self.standby_peers or self.lease_path:
            if self.forward_address:
                raise ValueError(
                    "standby_peers/lease_path require a GLOBAL instance, "
                    "but forward_address is set (a local has no merged "
                    "store to replicate). Unset one of them")
            if self.standby_peers and not self.http_address:
                raise ValueError(
                    "standby_peers requires http_address: standbys "
                    "receive replication on POST /replicate and serve "
                    "GET /ha-status on it")
        if self.standby_shadow_epochs < 0:
            raise ValueError(
                f"standby_shadow_epochs must be >= 0 (0 = use the "
                f"default, 2), got {self.standby_shadow_epochs}")
        if self.lease_path and not (
                self.lease_path.startswith("file://")
                or self.lease_path.startswith("consul://")):
            raise ValueError(
                f"lease_path must be file:///path or consul://key, got "
                f"{self.lease_path!r}")
        self.standby_shadow_epochs = self.standby_shadow_epochs or 2
        if self.sentry_dsn:
            from veneur_tpu_torch.crash import SentryReporter

            SentryReporter(self.sentry_dsn)  # a malformed DSN raises
        for name in ("handoff_refresh_interval", "handoff_timeout",
                     "lease_ttl", "lease_renew_interval",
                     "fleet_pull_interval", "fleet_pull_timeout"):
            if getattr(self, name):
                parse_duration(getattr(self, name))  # malformed raises

    @property
    def handoff_refresh_interval_seconds(self) -> float:
        return (parse_duration(self.handoff_refresh_interval)
                if self.handoff_refresh_interval else 10.0)

    @property
    def handoff_timeout_seconds(self) -> float:
        """A handoff POST's budget; unset, the forward budget."""
        return (parse_duration(self.handoff_timeout) if self.handoff_timeout
                else self.forward_timeout_seconds)

    @property
    def fleet_pull_interval_seconds(self) -> float:
        return (parse_duration(self.fleet_pull_interval)
                if self.fleet_pull_interval else 5.0)

    @property
    def fleet_pull_timeout_seconds(self) -> float:
        return (parse_duration(self.fleet_pull_timeout)
                if self.fleet_pull_timeout else 2.0)

    @property
    def lease_ttl_seconds(self) -> float:
        return parse_duration(self.lease_ttl) if self.lease_ttl else 15.0

    @property
    def lease_renew_interval_seconds(self) -> float:
        return (parse_duration(self.lease_renew_interval)
                if self.lease_renew_interval
                else self.lease_ttl_seconds / 3.0)

    @property
    def interval_seconds(self) -> float:
        return parse_duration(self.interval)

    @property
    def forward_timeout_seconds(self) -> float:
        return parse_duration(self.forward_timeout)

    @property
    def retry_base_interval_seconds(self) -> float:
        return parse_duration(self.retry_base_interval)

    @property
    def breaker_reset_timeout_seconds(self) -> float:
        return parse_duration(self.breaker_reset_timeout)

    @property
    def compute_breaker_reset_timeout_seconds(self) -> float:
        return parse_duration(self.compute_breaker_reset_timeout)

    @property
    def checkpoint_interval_seconds(self) -> float:
        """The checkpoint cadence; 0.0 = unset (the server takes
        interval / 4)."""
        return (parse_duration(self.checkpoint_interval)
                if self.checkpoint_interval else 0.0)


# values that leave an unimplemented key switched off
_OFF_VALUES = (None, "", [], {}, False)

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
                   "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(s: str) -> float:
    """Go-style duration string -> seconds ("10s", "1m30s", "50ms")."""
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return total


def config_from_dict(data: dict) -> Config:
    """Config from a parsed mapping; raises UnsupportedConfig on any key
    :class:`Config` does not have (switched-off values excepted)."""
    known = {f.name for f in dataclasses.fields(Config)}
    unsupported = sorted(
        k for k, v in data.items()
        if k not in known and v not in _OFF_VALUES)
    if unsupported:
        raise UnsupportedConfig(
            f"unknown configuration keys: {unsupported}")
    return Config(**{k: v for k, v in data.items()
                     if k in known and v is not None})


def read_config(path: str) -> Config:
    """Load a YAML config file."""
    import yaml  # the card's machine may lack PyYAML; only files need it

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError("config must be a YAML mapping")
    return config_from_dict(data)


@dataclass
class ProxyConfig:
    """veneur-proxy configuration (config_proxy.go:3-18; the JAX
    package's ``ProxyConfig``), plus the egress-resilience keys the
    server's :class:`Config` shares. Built directly, call
    :meth:`finalize` (the :class:`~veneur_tpu_torch.proxy.proxy.Proxy`
    does); :func:`read_proxy_config` does it for a file."""

    consul_forward_service_name: str = ""
    consul_refresh_interval: str = ""
    consul_trace_service_name: str = ""
    debug: bool = False
    # accepted and not read, as in the JAX package's proxy
    enable_profiling: bool = False
    forward_address: str = ""
    forward_timeout: str = ""
    http_address: str = ""
    # the cadence of the proxy's own runtime metrics (accepted, not
    # read, as stats_address)
    runtime_metrics_interval: str = ""
    # accepted and not read, as in the JAX package's proxy (these four)
    sentry_dsn: str = ""
    ssf_destination_address: str = ""
    stats_address: str = ""
    trace_api_address: str = ""
    # static /spans destination (no Consul trace service)
    trace_address: str = ""
    # the gRPC proxy's listener (Forward.SendMetrics); needs grpcio
    grpc_forward_address: str = ""
    retry_max: int = -1
    retry_base_interval: str = ""
    breaker_failure_threshold: int = 0
    breaker_reset_timeout: str = ""
    # the proxy arms the churn kinds (its discovery refresh)
    fault_injection_rate: float = 0.0
    fault_injection_seed: int = 0
    fault_injection_kinds: str = ""
    fault_injection_scope: str = ""

    def finalize(self) -> "ProxyConfig":
        """Refuse what the port does not implement, fill the defaults and
        check the durations; idempotent."""
        if self.grpc_forward_address:
            require_grpc("grpc_forward_address")
        if self.breaker_failure_threshold < 0:
            raise ValueError(
                f"breaker_failure_threshold must be >= 0 (0 = use the "
                f"default, {_BREAKER_THRESHOLD_DEFAULT}; breakers cannot "
                f"be disabled), got {self.breaker_failure_threshold}")
        _check_fault_kinds(self)
        self.consul_refresh_interval = self.consul_refresh_interval or "30s"
        self.forward_timeout = self.forward_timeout or "10s"
        if self.retry_max < 0:
            self.retry_max = 2
        self.retry_base_interval = self.retry_base_interval or "100ms"
        self.breaker_failure_threshold = (self.breaker_failure_threshold
                                          or _BREAKER_THRESHOLD_DEFAULT)
        self.breaker_reset_timeout = self.breaker_reset_timeout or "30s"
        for name in ("consul_refresh_interval", "forward_timeout",
                     "retry_base_interval", "breaker_reset_timeout"):
            parse_duration(getattr(self, name))  # malformed raises here
        if self.runtime_metrics_interval:
            parse_duration(self.runtime_metrics_interval)
        return self

    @property
    def forward_timeout_seconds(self) -> float:
        return parse_duration(self.forward_timeout)

    @property
    def refresh_interval_seconds(self) -> float:
        return parse_duration(self.consul_refresh_interval)

    @property
    def retry_base_interval_seconds(self) -> float:
        return parse_duration(self.retry_base_interval)

    @property
    def breaker_reset_timeout_seconds(self) -> float:
        return parse_duration(self.breaker_reset_timeout)


def proxy_config_from_dict(data: dict) -> ProxyConfig:
    """ProxyConfig from a parsed mapping, finalized; a key the proxy does
    not know raises UnsupportedConfig (switched-off values excepted)."""
    known = {f.name for f in dataclasses.fields(ProxyConfig)}
    unsupported = sorted(
        k for k, v in data.items()
        if k not in known and v not in _OFF_VALUES)
    if unsupported:
        raise UnsupportedConfig(
            f"unknown proxy configuration keys: {unsupported}")
    return ProxyConfig(**{k: v for k, v in data.items()
                          if k in known and v is not None}).finalize()


def read_proxy_config(path: str) -> ProxyConfig:
    """Load a veneur-proxy YAML file (``example_proxy.yaml``)."""
    import yaml  # the card's machine may lack PyYAML; only files need it

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError("proxy config must be a YAML mapping")
    return proxy_config_from_dict(data)
