"""The whole fit: the configuration's counted fit work
(``counts/<config>.py``) over the untraced window's seconds per fit at
the card's float32 peak, in percent."""


def read(ctx):
    if ctx.peaks is None or not ctx.fit_s or not ctx.answers:
        return None
    flops = ctx.count(ctx.config["name"]).fit_flops(ctx)
    return 100.0 * flops / (ctx.fit_s * ctx.peaks["fp32_flops"])
