"""Mean host ms a frame spends in voxelize, pad and the copy to the card:
the reading of ``host_prep_ms.eval``, in the cell whose speed is read per
layer."""


def read(ctx):
    return ctx.get('host_prep_ms')
