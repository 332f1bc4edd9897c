"""weight_cast_mb.span: megabytes (1e6 bytes) per call of parameters cast
to another dtype inside a forward (the program's ``cast_bytes`` counter:
`run_in`, the tensor-parallel Linear, GroupNorm's affine, the DiT's
frequency embedding, the vocoders' upsampling weights; the bytes of each
cast's result), summed over the call's spans; the mean over the window's
calls of the traced run."""

from benchmark.program_spans import counted, mean_per_call


def read(run):
    return mean_per_call(run, lambda call: counted(call, "cast_bytes") / 1e6)
