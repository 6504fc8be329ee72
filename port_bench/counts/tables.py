"""B3, the prediction tables of a fit: table_s[j] = sum of coeff_s[i] beta_i
over the points i in slot j.

Reads the slot and coefficient of every (instance, point) and beta once,
and writes the (m, B) tables once.  Two operations an (instance, point).
"""


def cost(cfg):
    m, n, b = cfg["m"], cfg["n_points"], cfg["table_size"]
    return {"flops": 2.0 * m * n,
            "bytes": 8.0 * m * n + 4.0 * n + 4.0 * m * b}
