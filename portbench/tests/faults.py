"""Faults planted under the timed path, for the tests that see the check
fail them: the port's ring steps wrapped so that a step returns its state
unchanged, leaves half of the batch out, or alters an answer where it is
produced."""

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
STEPS = ("absdiff_step_ring", "batch_step_ring", "absdiff_step_ring_stacked",
         "batch_step_ring_stacked")


def wrapped(step, fault: str):
    """``step`` with ``fault`` planted."""
    # positions of the heatmap and the valid flags in the steps' calls
    hi = (8 if step.__name__.startswith("batch") else 7) \
        + step.__name__.endswith("stacked")

    def broken(*args, **kw):
        args = list(args)
        heat, kept = args[hi], args[hi].clone()
        if fault == "half_batch":
            valid = args[hi + 1].copy()
            if valid.ndim == 2 and valid.shape[1] == 1:
                valid[valid.shape[0] // 2:] = False  # one frame a stream
            else:
                valid[..., valid.shape[-1] // 2:] = False
            args[hi + 1] = valid
        res = step(*args, **kw)
        if fault == "state_unchanged":
            heat.copy_(kept)
        elif fault == "answer_altered":
            res[0].view(-1)[7] ^= 0x40  # a wrong byte, not a rounding
        return res
    broken.__name__ = step.__name__
    return broken


def plant(setattr_, fault: str) -> None:
    """Wrap every ring step of ``dips_tpu_torch.ops.cuda_fused`` with
    ``setattr_(module, name, value)``."""
    from dips_tpu_torch.ops import cuda_fused
    for name in STEPS:
        setattr_(cuda_fused, name, wrapped(getattr(cuda_fused, name), fault))
