"""Forwarding tier of the port: a local's sketch state to a global over
HTTP ``POST /import`` (flusher.go:292-385, http.go:41-143).

Port of the HTTP half of ``veneur_tpu/forward/``. The import side reads
both our structured JSON and the reference's gob/axiomhq entries, and
``forward_reference_compatible`` makes a local send the reference's
format. The gRPC transport and the framed native transport are not
ported: :class:`~veneur_tpu_torch.config.Config` refuses them.
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
    """Attach the configured HTTP forwarder to a local server
    (flusher.go:66-75), with the retry policy, a breaker for the one
    upstream destination and ``forward_timeout`` as its per-flush
    budget. Returns the forwarder, or None when ``forward_address`` is
    unset."""
    from veneur_tpu_torch.resilience import CircuitBreaker, RetryPolicy

    cfg = server.config
    if not cfg.forward_address:
        return None
    fwd = HTTPForwarder(
        cfg.forward_address, timeout=cfg.forward_timeout_seconds,
        reference_compat=cfg.forward_reference_compatible,
        retry_policy=RetryPolicy.from_config(cfg),
        breaker=CircuitBreaker(
            failure_threshold=cfg.breaker_failure_threshold,
            reset_timeout=cfg.breaker_reset_timeout_seconds,
            name=cfg.forward_address))
    server.forward_fn = fwd.forward
    return fwd
