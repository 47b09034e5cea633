"""fill.roofline: the frozen bound of one fill launch (`costs.fill_cost`
at the step's rows and n) over the fill kernels' mean device time a
launch (`pack_kernel` + `fill_acc_kernel` of `csrc/sti_fill.cu`, from
the trace), in %."""

from portbench.costs import fill_cost


def read(records):
    k = records.get("kernels") or {}
    launches = sum(c[0] for nm, c in k.items() if "fill_acc_kernel" in nm)
    secs = sum(c[1] for nm, c in k.items()
               if "fill_acc_kernel" in nm or "pack_kernel" in nm)
    if not launches or secs <= 0:
        return None
    bound = fill_cost(records["rows_per_step"], records["n"]).bound_ms()
    return 100.0 * bound / (1e3 * secs / launches)
