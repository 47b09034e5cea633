"""distance.roofline: the frozen bound of one distance launch
(`costs.distance_cost` at the step's rows, n, d, f32) over the distance
kernels' mean device time a launch (`sq_norms_kernel` + `sq_dist_kernel`
of `csrc/distance.cu`, from the trace), in %."""

from portbench.costs import distance_cost


def read(records):
    k = records.get("kernels") or {}
    launches = sum(c[0] for nm, c in k.items() if "sq_dist_kernel" in nm)
    secs = sum(c[1] for nm, c in k.items()
               if "sq_dist_kernel" in nm or "sq_norms_kernel" in nm)
    if not launches or secs <= 0:
        return None
    bound = distance_cost(records["rows_per_step"], records["n"],
                          records["d"], 4).bound_ms()
    return 100.0 * bound / (1e3 * secs / launches)
