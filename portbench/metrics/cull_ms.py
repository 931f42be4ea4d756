"""Update + cull + LOD: the spans of passes/update.py compute_update and
passes/cull.py emit_draws inside each frame, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.update", "compute_update"),
         ("voidin_tpu_torch.passes.cull", "emit_draws")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
