"""Seconds per fit: the whole window over the fits completed in it."""


def read(ctx):
    return ctx.fit_s
