"""B1, featurize: hash and weigh ``rows`` points under the m instances.

Reads the points (rows x d) and the instances' w, z, r1, r2 (m x d each);
writes what the table index needs of each (instance, point): its slot and
its coefficient weight * sign.  Five float32 operations a coordinate and
instance: the difference, the quotient, the rounding, the bucket offset
and the weight's product (the hashes are integer work).
"""


def cost(cfg, rows):
    m, d = cfg["m"], cfg["dim"]
    return {"flops": 5.0 * m * rows * d,
            "bytes": 4.0 * rows * d + 16.0 * m * d + 8.0 * m * rows}
