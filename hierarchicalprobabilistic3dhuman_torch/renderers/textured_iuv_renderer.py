"""Orthographic per-vertex-colour IUV/RGB renderer, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/renderers/
textured_iuv_renderer.py (preprocess_densepose_UV :35, _vertex_normals :86,
_to_screen :183, _phong :201, __call__ :232) for the predict visualisation
and the evaluation's silhouettes: orthographic projection
x_pix = scale*(W/2)*(X+tx) + W/2, point-light Phong shading of per-vertex
colours, DensePose IUV per pixel. With render_rgb=False (the JAX renderer's
:257-291) the attributes are the 3 IUV channels alone, with no normals,
lights or colour, and the render is IUV, depth and silhouettes. The rasterization
goes through ops/rasterizer_cuda.py: the hand-written kernel for CUDA
tensors, its plain torch version for CPU tensors.
"""

from functools import lru_cache

import numpy as np
import torch
from scipy.io import loadmat

from hierarchicalprobabilistic3dhuman_torch.configs import paths
from hierarchicalprobabilistic3dhuman_torch.ops.rasterizer_cuda import rasterize


@lru_cache(maxsize=1)
def preprocess_densepose_UV():
    """Load UV_Processed.mat and compute atlas-offset UVs + per-vertex IUV.

    :return dict of numpy arrays:
        faces (13774, 3) int32 into DP vertex indexing,
        verts_map (7829,) int32 DP vertex -> SMPL vertex,
        verts_uv_offset (7829, 2) atlas UVs (6x4 grid of 24 parts),
        verts_iuv (7829, 3) [part, U, 1-V] per vertex.
    """
    DP_UV = loadmat(paths.DP_UV_PROCESSED_FILE)
    face_parts = DP_UV["All_FaceIndices"].squeeze().astype(np.int32)
    faces = (DP_UV["All_Faces"] - 1).astype(np.int32)
    verts_map = (DP_UV["All_vertices"][0] - 1).astype(np.int32)
    u_norm = DP_UV["All_U_norm"].astype(np.float32)[:, 0]
    v_norm = DP_UV["All_V_norm"].astype(np.float32)[:, 0]

    # Atlas offsets: 4 columns (u) x 6 rows (v); part = 6*i + j + 1.
    cols_n, rows_n = 4, 6
    offset_u = np.zeros(25, np.float32)
    offset_v = np.zeros(25, np.float32)
    for i, u in enumerate(np.linspace(0, 1, cols_n, endpoint=False)):
        for j, v in enumerate(np.linspace(0, 1, rows_n, endpoint=False)):
            offset_u[rows_n * i + j + 1] = u
            offset_v[rows_n * i + j + 1] = v

    flat = faces.reshape(-1)
    flat_parts = np.repeat(face_parts, 3)
    # The first face containing a vertex decides its UV-offset part, the
    # last one its IUV part label.
    _, first_idx = np.unique(flat, return_index=True)
    part_first = np.zeros(len(verts_map), np.int32)
    part_first[flat[first_idx]] = flat_parts[first_idx]
    _, last_rev_idx = np.unique(flat[::-1], return_index=True)
    last_idx = len(flat) - 1 - last_rev_idx
    part_last = np.zeros(len(verts_map), np.int32)
    part_last[flat[last_idx]] = flat_parts[last_idx]

    u_off = u_norm / cols_n + offset_u[part_first]
    v_off = 1.0 - ((1.0 - v_norm) / rows_n + offset_v[part_first])
    verts_uv_offset = np.stack([u_off, v_off], axis=-1)
    verts_iuv = np.stack([part_last.astype(np.float32), u_norm, 1.0 - v_norm],
                         axis=-1)
    return {"faces": faces, "verts_map": verts_map,
            "verts_uv_offset": verts_uv_offset, "verts_iuv": verts_iuv}


def _vertex_normals(verts, faces):
    """Area-weighted per-vertex normals by scatter-add. verts (B, V, 3),
    faces (F, 3) int64."""
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)    # (B, F, 3)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(1, faces[:, k], fn)
    norm = torch.linalg.vector_norm(vn, dim=-1, keepdim=True)
    return vn / torch.clamp(norm, min=1e-12)


def _unit(v, eps=1e-9):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


class TexturedIUVRenderer:
    """Orthographic renderer of SMPL meshes with per-vertex colours.

    :param device: where the DensePose tables live (the meshes' device)
    :param img_wh: square output size
    :param render_rgb: shade per-vertex colours (A = 12 attributes per
        vertex); False renders IUV, depth and silhouettes alone (A = 3)
    """

    def __init__(self, device, img_wh=512, render_rgb=True):
        self.img_wh = img_wh
        self.render_rgb = render_rgb
        dp = preprocess_densepose_UV()
        self.faces = torch.as_tensor(dp["faces"], dtype=torch.int64, device=device)
        self.verts_map = torch.as_tensor(dp["verts_map"], dtype=torch.int64,
                                         device=device)
        self.verts_iuv = torch.as_tensor(dp["verts_iuv"], device=device)
        self.background_color = torch.zeros(3, device=device)

    def _to_screen(self, verts, cam_t, orthographic_scale):
        """verts (B, V, 3) + cam_t (B, 3) -> screen [x_pix, y_pix, z].

        z is shifted by the minimum over the WHOLE batch, as in the JAX
        package, so depths match it mesh for mesh.
        """
        wh = self.img_wh
        p = verts + cam_t[:, None, :]
        xy = orthographic_scale[:, None, :] * (wh / 2.0) * p[..., :2] + wh / 2.0
        z = p[..., 2:3] - torch.min(p[..., 2]) + 1.0
        return torch.cat([xy, z], dim=-1)

    def _phong(self, texel, normal, world_pos, lights, mask, shininess=64.0):
        """Point-light shading; light settings are (B, 3) per example."""
        lights = {k: v[:, None, None, :] for k, v in lights.items()}
        l_dir = _unit(lights["location"] - world_pos)
        n = _unit(normal)
        v_dir = _unit(-world_pos)          # camera at the origin looking +z
        ndotl = torch.clamp(torch.sum(n * l_dir, dim=-1, keepdim=True), min=0.0)
        r = 2.0 * ndotl * n - l_dir
        rdotv = torch.clamp(torch.sum(r * v_dir, dim=-1, keepdim=True), min=0.0)
        color = (texel * (lights["ambient_color"]
                          + lights["diffuse_color"] * ndotl)
                 + lights["specular_color"] * rdotv ** shininess)
        return color * mask[..., None]

    def raster_inputs(self, vertices, cam_t, orthographic_scale,
                      verts_features=None):
        """Screen-space DensePose vertices and their attributes: A=12
        [IUV | normal | camera position | colour], or A=3 [IUV] without
        render_rgb.

        :return: screen (B, 7829, 3), vert_attrs (B, 7829, A)
        """
        verts_dp = vertices[:, self.verts_map, :]
        screen = self._to_screen(verts_dp, cam_t, orthographic_scale)
        B = vertices.shape[0]
        attrs = [self.verts_iuv.expand((B,) + self.verts_iuv.shape)]
        if self.render_rgb:
            cam_space = verts_dp + cam_t[:, None, :]
            attrs += [_vertex_normals(cam_space, self.faces), cam_space,
                      verts_features[:, self.verts_map, :]]
        return screen, torch.cat(attrs, dim=-1)

    def __call__(self, vertices, cam_t, orthographic_scale,
                 lights_rgb_settings=None, verts_features=None):
        """Render a batch of SMPL meshes.

        :param vertices: (B, 6890, 3) SMPL-indexed vertices (camera frame)
        :param cam_t: (B, 3) camera translation
        :param orthographic_scale: (B, 2)
        :param lights_rgb_settings: dict location/ambient_color/
            diffuse_color/specular_color, each (B, 3) (with render_rgb)
        :param verts_features: (B, 6890, 3) per-vertex RGB (with render_rgb)
        :return: dict iuv_images (B, H, W, 3), depth_images (B, H, W),
                 silhouettes (B, H, W) float32, and with render_rgb
                 rgb_images (B, H, W, 3)
        """
        screen, vert_attrs = self.raster_inputs(vertices, cam_t,
                                                orthographic_scale,
                                                verts_features)
        out = rasterize(screen, self.faces, vert_attrs, (self.img_wh, self.img_wh))
        attrs, depth, mask = out["attrs"], out["depth"], out["mask"]
        result = {
            "iuv_images": attrs[..., :3] * mask[..., None],
            "depth_images": torch.where(mask, depth, torch.zeros_like(depth)),
            "silhouettes": mask.to(torch.float32),
        }
        if self.render_rgb:
            rgb = self._phong(attrs[..., 9:12], attrs[..., 3:6], attrs[..., 6:9],
                              lights_rgb_settings, mask)
            rgb = torch.where(mask[..., None], rgb, self.background_color)
            result["rgb_images"] = torch.clamp(rgb, 0.0, 1.0)
        return result
