"""Telemetry of the port: the metrics registry."""

from .registry import MetricsRegistry

__all__ = ["MetricsRegistry"]
