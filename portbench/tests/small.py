"""Cells of the manifest cut to a size a CPU test run holds."""

from portbench import run

SMALL = {
    "turb512.orbit": dict(config=dict(domain=16, brick=8),
                          traffic=dict(width=32, height=32, batch=4, warmup_batches=1,
                                       check_within=4, trace_after_calls=1)),
    "insitu32.fit": dict(config=dict(domain=8, brick=4),
                         traffic=dict(width=12, height=12, views=4, trace_after_calls=1)),
}


def small_cell(name: str) -> dict:
    spec = run.load_cell(name)
    cut = SMALL[name]
    spec["config"] = dict(spec["config"], **cut["config"])
    spec["traffic"] = dict(spec["traffic"], **cut["traffic"])
    return spec
