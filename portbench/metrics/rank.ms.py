"""rank.ms: device milliseconds a step of the kernels launched from
inside `aten::sort` and `aten::scatter_` (the stable sort of the
distances and `ranks_from_order`), from the trace."""


def read(records):
    if not records.get("rank_s") or not records.get("steps"):
        return None
    return 1e3 * records["rank_s"] / records["steps"]
