from disco4est_tpu_torch.elliptic.problem import EllipticProblem  # noqa: F401
