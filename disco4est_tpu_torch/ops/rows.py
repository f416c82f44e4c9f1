"""Fixed-order accumulation of per-face rows into their elements.

The JAX package adds per-face rows (the mortar lifts, the mortar η²
terms) into their elements with a one-hot product or a scatter-add,
which sum in a fixed order on its backends.  `index_add` on a CUDA
tensor runs as atomics, whose order, and so whose rounding, changes from
run to run (ROADMAP C10).  Where each (element, face) pair has at most
one row, the face is the row's slot: each row is written to its own
place of an [E, 2d] block (no two writes meet), and the block is summed
over the faces, in the same order on every run.
"""

from __future__ import annotations


def add_face_rows(out, rows, elem, face, nfaces: int):
    """out [E, ...] with each row of `rows` [R, ...] added to
    out[elem[r]] (out-of-place); the (elem, face) pairs must be
    distinct."""
    E = out.shape[0]
    buf = rows.new_zeros((E * nfaces,) + rows.shape[1:])
    buf = buf.index_copy(0, elem.long() * nfaces + face.long(), rows)
    return out + buf.reshape((E, nfaces) + rows.shape[1:]).sum(1)
