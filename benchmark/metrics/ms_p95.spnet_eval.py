"""95th percentile of the latency of the traced run's frames that ran
outside the profiler: ``eval_ms_p95`` where that is too noisy to hold to a
bound."""


def read(ctx):
    return ctx.get('ms_p95')
