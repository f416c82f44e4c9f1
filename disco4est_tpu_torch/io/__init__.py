import numpy as np
import torch


def to_host(arr) -> np.ndarray:
    """A tensor as a numpy array (one device-to-host copy); other arrays
    as they are."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)
