"""mfu.sti_step: the frozen bound of a whole sti step
(`costs.sti_megakernel_cost`, whatever implements the step) over the
traced window's seconds a step, in %."""

from portbench.costs import sti_megakernel_cost


def read(records):
    if not records.get("steps") or records["config"]["method"] != "sti":
        return None
    bound = sti_megakernel_cost(records["rows_per_step"], records["n"],
                                records["d"]).bound_ms()
    return 100.0 * bound / (1e3 * records["window_s"] / records["steps"])
