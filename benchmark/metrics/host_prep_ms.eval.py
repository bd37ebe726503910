"""Mean host ms a frame spends in voxelize, pad and the copy to the card."""


def read(ctx):
    return ctx.get('host_prep_ms')
