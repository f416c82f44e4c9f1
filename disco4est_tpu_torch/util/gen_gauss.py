"""Write `ops/gauss_table.py`: the Gauss and Gauss-Lobatto rules the port
uses.

Both rules come out of numpy arithmetic whose last bits depend on the
numpy version: `leggauss` starts from LAPACK eigenvalues, and the
Gauss-Lobatto Newton iteration below evaluates Legendre series with
`legval`.  Between numpy 2.0.2 and 2.3.5 the Gauss weights differ by up
to 33 ulp (6 to 9 nodes), the Gauss-Lobatto weights from 5 nodes and
their nodes from 6 nodes up, and together they moved the L2 error of
sinx at deg 5 (7.4e-13, at the f64 floor) by 6.1e-4 relative (ROADMAP
C9).  The port therefore reads its rules from a table of exact hex
floats.  The committed table was written under numpy 2.0.2,
whose rules the JAX package's reference values were computed with.
Regenerate only under that version:

    python -m disco4est_tpu_torch.util.gen_gauss
"""

from __future__ import annotations

import pathlib

import numpy as np

MAX_NODES = 32
OUT = pathlib.Path(__file__).resolve().parents[1] / "ops" / "gauss_table.py"

HEAD = '''\
"""Gauss-Legendre (1..{max} nodes) and Gauss-Lobatto-Legendre (2..{max}
nodes) nodes and weights on [-1, 1], as hex floats, computed under numpy
{version}.  Generated by `python -m disco4est_tpu_torch.util.gen_gauss`;
do not edit."""

MAX_NODES = {max}
'''


def lobatto(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre nodes/weights on [-1, 1].

    Newton iteration on q(x) = (1-x²) P'_N(x) with Chebyshev-Gauss-Lobatto
    initial guess; weights w_i = 2 / (N (N+1) P_N(x_i)²) with the
    *unnormalized* Legendre polynomial P_N (the JAX package's
    `ops/lgl.py:lobatto_nodes_weights`).
    """
    N = n_nodes - 1
    leg = np.polynomial.legendre
    x = -np.cos(np.pi * np.arange(n_nodes) / N)
    c = np.zeros(n_nodes)
    c[N] = 1.0
    for _ in range(100):
        dpN = leg.legval(x, leg.legder(c))
        d2pN = leg.legval(x, leg.legder(c, 2))
        # q = (1-x²) dpN;  q' = -2x dpN + (1-x²) d2pN
        q = (1.0 - x**2) * dpN
        dq = -2.0 * x * dpN + (1.0 - x**2) * d2pN
        dx = np.zeros_like(x)
        dx[1:N] = q[1:N] / dq[1:N]
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[N] = -1.0, 1.0
    w = 2.0 / (N * (N + 1) * leg.legval(x, c) ** 2)
    return x, w


def _row(values):
    """A tuple literal of hex floats, two a line."""
    items = [f'"{float(v).hex()}",' for v in values]
    lines = [" ".join(items[i:i + 2]) for i in range(0, len(items), 2)]
    return "(\n" + "".join(f"{' ' * 12}{line}\n" for line in lines) + \
        f"{' ' * 8}),\n"


def _rules(name, first, rule):
    lines = [f"# n: (nodes, weights)\n{name} = {{\n"]
    for n in range(first, MAX_NODES + 1):
        x, w = rule(n)
        lines.append(f"    {n}: (\n        {_row(x)}        {_row(w)}"
                     f"    ),\n")
    lines.append("}\n")
    return "".join(lines)


def render() -> str:
    return "\n".join([
        HEAD.format(max=MAX_NODES, version=np.__version__),
        _rules("GAUSS", 1, np.polynomial.legendre.leggauss),
        _rules("LOBATTO", 2, lobatto),
    ])


def main():
    OUT.write_text(render())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
