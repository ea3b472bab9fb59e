"""serve.tick_ms: the engine's decode thread, host milliseconds a tick
(``EngineStats.busy_seconds_total`` over ``ticks_total`` in the window
before the traced stretch: admission copies, a round's launches, the
harvest)."""


def read(run):
    ticks = run.facts.get("ticks_total", 0)
    return 1e3 * run.facts["busy_seconds_total"] / ticks if ticks else None
