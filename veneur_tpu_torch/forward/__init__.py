"""Forwarding tier of the port: a local's sketch state to a global over
HTTP ``POST /import`` (flusher.go:292-385, http.go:41-143), over gRPC
``Forward.SendMetrics`` (flusher.go:424-473, ``grpc_forward.py``) or over
the framed-TCP MetricList lane (``native://``, ``native_transport.py``).

Port of ``veneur_tpu/forward/``. The HTTP import side reads both our
structured JSON and the reference's gob/axiomhq entries, and
``forward_reference_compatible`` makes a local send the reference's
format. The gRPC and native lanes send the same MetricList frames and
merge them through the same ``import_columnar`` body; neither needs
protobuf, and gRPC needs grpcio, which the config checks.
"""

from veneur_tpu_torch.forward.convert import (apply_json_metric,
                                              apply_json_metric_list,
                                              decode_hll, encode_hll,
                                              json_metrics_from_state)
from veneur_tpu_torch.forward.http_forward import HTTPForwarder

__all__ = [
    "apply_json_metric",
    "apply_json_metric_list",
    "configure_forwarding",
    "decode_hll",
    "encode_hll",
    "json_metrics_from_state",
    "HTTPForwarder",
]


def configure_forwarding(server):
    """Attach the configured forwarder to a local server
    (flusher.go:66-75, server.go:626-635): ``native://host:port`` the
    framed-TCP one, else with ``forward_use_grpc`` the gRPC one, else
    the HTTP one; each with the retry policy, a breaker for the one
    upstream destination, ``forward_timeout`` as its per-flush budget
    and, with ``fault_injection_rate`` above 0, an injector of its own
    (``resilience/faults.py``). ``forward_packed_digests: false`` keeps
    the native and gRPC wires' digests dense (float64 centroids), for a
    global that does not read the quantized fields. Returns the
    forwarder, or None when ``forward_address`` is unset."""
    from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy
    from veneur_tpu_torch.resilience import faults

    cfg = server.config
    if not cfg.forward_address:
        return None
    resilience = dict(
        timeout=cfg.forward_timeout_seconds,
        reference_compat=cfg.forward_reference_compatible,
        retry_policy=RetryPolicy.from_config(cfg),
        breaker=CircuitBreaker(
            failure_threshold=cfg.breaker_failure_threshold,
            reset_timeout=cfg.breaker_reset_timeout_seconds,
            name=cfg.forward_address),
        fault_injector=faults.from_config(cfg))
    if cfg.forward_address.startswith("native://"):
        from veneur_tpu_torch.forward.native_transport import \
            NativeForwarder

        fwd = NativeForwarder(cfg.forward_address, **resilience)
    elif cfg.forward_use_grpc:
        from veneur_tpu_torch.forward.grpc_forward import GRPCForwarder

        fwd = GRPCForwarder(cfg.forward_address, **resilience)
    else:
        fwd = HTTPForwarder(cfg.forward_address, **resilience)
    if not cfg.forward_packed_digests:
        # HTTP ignores it (its JSON wire carries no packed digests)
        fwd.wants_packed_digests = False
    server.forward_fn = fwd.forward
    return fwd

