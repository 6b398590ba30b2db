"""SMPL shape parameter sampling, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/augmentation/
smpl_augmentation.py (uniform_sample_shape :6, normal_sample_shape :14,
uniform_random_unit_vector :21). `draws` is a utils/random_draws.py source,
where the JAX functions take a key.
"""

import torch


def uniform_sample_shape(draws, batch_size, mean_shape, delta_betas_range):
    """Uniform shape deviations from the mean."""
    l, h = delta_betas_range
    return mean_shape + draws.uniform((batch_size, mean_shape.shape[0]), l, h)


def normal_sample_shape(draws, batch_size, mean_shape, std_vector):
    """Gaussian shape deviations from the mean."""
    return mean_shape + draws.normal((batch_size, mean_shape.shape[0])) * std_vector


def uniform_random_unit_vector(draws, num_vectors):
    """Uniform random points on the unit sphere."""
    e = draws.normal((num_vectors, 3))
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
