"""Work completed per second: the sum of one count over every operation of
the window, over the window's seconds, times `scale`.

params: {"stat": "rate", "count": <key of Op.counts>, "scale": <factor>}
"""


def value(ops, window_s: float, params: dict) -> float:
    work = sum(op.counts[params["count"]] for op in ops)
    return work / window_s * float(params.get("scale", 1.0))
