from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
