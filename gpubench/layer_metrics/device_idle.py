"""``device_idle.<cell kind>``: the share of the traced window in which no
device operation ran, in %."""


def read(ctx):
    reading = ctx.get("trace")
    if not reading or reading["window_s"] <= 0 or reading["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])
