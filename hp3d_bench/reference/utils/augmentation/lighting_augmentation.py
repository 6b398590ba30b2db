"""Random point-light augmentation, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/utils/augmentation/
lighting_augmentation.py (augment_light_t :7, augment_light_colour :18,
augment_light :32).
"""

import torch


def augment_light_t(draws, batch_size, loc_r_range=(0.05, 3.0)):
    """Random light positions: uniform direction on the sphere, uniform
    radius."""
    draws_dir, draws_r = draws.split(2)
    direction = draws_dir.normal((batch_size, 3))
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    l, h = loc_r_range
    return direction * draws_r.uniform((batch_size, 1), l, h)


def augment_light_colour(draws, batch_size,
                         ambient_intensity_range=(0.2, 0.8),
                         diffuse_intensity_range=(0.2, 0.8),
                         specular_intensity_range=(0.2, 0.8)):
    """Random white-light intensities: (ambient, diffuse, specular), each
    (B, 3)."""
    out = []
    for d, (l, h) in zip(draws.split(3), [ambient_intensity_range,
                                          diffuse_intensity_range,
                                          specular_intensity_range]):
        out.append(d.uniform((batch_size, 1), l, h).expand(batch_size, 3))
    return tuple(out)


def augment_light(draws, batch_size, rgb_augment_config):
    """The renderer's light settings dict, each value (B, 3)."""
    draws_t, draws_c = draws.split(2)
    light_t = augment_light_t(draws_t, batch_size,
                              loc_r_range=rgb_augment_config.LIGHT_LOC_RANGE)
    ambient, diffuse, specular = augment_light_colour(
        draws_c, batch_size,
        ambient_intensity_range=rgb_augment_config.LIGHT_AMBIENT_RANGE,
        diffuse_intensity_range=rgb_augment_config.LIGHT_DIFFUSE_RANGE,
        specular_intensity_range=rgb_augment_config.LIGHT_SPECULAR_RANGE)
    return {"location": light_t, "ambient_color": ambient,
            "diffuse_color": diffuse, "specular_color": specular}
