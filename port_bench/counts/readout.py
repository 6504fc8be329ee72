"""The readout (B4's ``readout_kernel``) of ``rows`` queries: the mean
over the m instances of coeff times the table entry at the slot.

Reads each (instance, query)'s slot and coefficient, and writes one
prediction a query.  The table entries it addresses are not counted: how
many distinct ones a call reads depends on the data (a skewed layout
reads a few hundred, from cache), so the floor from the shapes alone
leaves them out.  Two operations an (instance, query): the product and
the add.
"""


def cost(cfg, rows):
    m = cfg["m"]
    return {"flops": 2.0 * m * rows,
            "bytes": 8.0 * m * rows + 4.0 * rows}
