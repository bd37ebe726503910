"""Frames a second over the traced run's window, the frames that ran under
the profiler and the stretch it recorded left out: ``eval_frames_s`` where
that is too noisy to hold to a bound."""


def read(ctx):
    return ctx.get('frames_s')
