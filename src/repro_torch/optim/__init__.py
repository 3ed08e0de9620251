"""Optimizers of the port: the reference's AdamW (fp32 or bf16 moments)
and Adafactor updates (``repro/optim/adamw.py``, ``adafactor.py``),
global-norm clipping (``clip.py``) over parameter trees of tensors, and
the warmup-cosine LR schedule (``schedule.py``)."""
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_by_global_norm_, global_norm
from repro_torch.optim.schedule import warmup_cosine


def make_optimizer(name: str, cfg=None, **kw):
    """The optimizer ``name`` (the reference's ``make_optimizer``). With
    ``cfg`` (a ``ModelConfig``), Adafactor clips each reference leaf over
    the layers of its segment (``Adafactor.segments``)."""
    if name == "adamw":
        return AdamW(moment_dtype="float32", **kw)
    if name == "adamw_bf16":
        return AdamW(moment_dtype="bfloat16", **kw)
    if name == "adafactor":
        if cfg is not None:
            kw.setdefault("segments", cfg.segment_layers())
        return Adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = ["Adafactor", "AdamW", "clip_by_global_norm_", "global_norm",
           "make_optimizer", "warmup_cosine"]
