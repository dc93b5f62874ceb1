"""Useful pair cells over the pair cells the objective's padded query
blocks hold: the sum over queries of length squared, over nb * QB *
Lmax^2 from the gradient state's [nb, QB, Lmax] shape.  Source: the
program's state (a count)."""


def read(rec):
    r = rec.get("rank") or {}
    if not r.get("pair_cells"):
        return None
    return r["useful_cells"] / r["pair_cells"] * 100.0
