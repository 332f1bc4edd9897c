"""sampler_idle_ms.span: milliseconds of device idle in one profiled call
whose ending launch the host made inside a ``sampler.step`` span: the
program's spans placed on the trace's clock (the offset between
``bench.prep`` and ``tts.prep``, held within 0.5 ms of the one between
``bench.vocoder`` and ``tts.vocoder``), each gap between merged device
intervals labelled by the host time of the launch that ended it."""

from benchmark.program_spans import idle_launched_in_ms, profiled


def read(run):
    call = profiled(run)
    return None if call is None else idle_launched_in_ms(run, call, "sampler.step")
