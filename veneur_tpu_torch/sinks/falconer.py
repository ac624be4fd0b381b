"""The Falconer span sink: the generic gRPC span sink under the name
``falconer`` (``sinks/falconer/falconer.go:11-17``)."""

from __future__ import annotations

from veneur_tpu_torch.sinks.grpsink import GRPCSpanSink


def new_falconer_span_sink(target: str, timeout: float = 10.0) -> GRPCSpanSink:
    return GRPCSpanSink(target, name="falconer", timeout=timeout)
