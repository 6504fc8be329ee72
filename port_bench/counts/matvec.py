"""B2 with its combine, one matvec K~ v = (1/m) sum_s C_s C_s^T v over
the n training points.

Reads every (instance, point)'s slot and coefficient once and v once, and
writes the n results.  The (m, B) tables in between need never reach
memory.  Four operations an (instance, point): the product with v and its
add into the table, the product of the table entry with the coefficient
and its add into the point's sum.
"""


def cost(cfg):
    m, n = cfg["m"], cfg["n_points"]
    return {"flops": 4.0 * m * n, "bytes": 8.0 * m * n + 8.0 * n}
