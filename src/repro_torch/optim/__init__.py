"""Optimizers of the port: the reference's AdamW update
(``repro/optim/adamw.py``), global-norm clipping (``clip.py``) over
parameter trees of tensors, and the warmup-cosine LR schedule
(``schedule.py``)."""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_by_global_norm_, global_norm
from repro_torch.optim.schedule import warmup_cosine


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    raise ValueError(f"the port has adamw only, not {name!r}")


__all__ = ["AdamW", "clip_by_global_norm_", "global_norm",
           "make_optimizer", "warmup_cosine"]
