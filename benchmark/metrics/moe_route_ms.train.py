"""moe_route_ms.train: the host's self time in the program's moe.route
(router, top-k, sort, offsets, dispatch) and moe.combine spans a train
step, in ms, from a pass of the traced steps with the program's spans
collected after the window."""


def read(rec):
    return rec.window.get("moe_route_ms")
