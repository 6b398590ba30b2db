"""Textured IUV/RGB/silhouette/depth renderer of SMPL meshes, in torch.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/renderers/
textured_iuv_renderer.py (preprocess_densepose_UV :35, _vertex_normals :86,
_sample_texture_bilinear :100, the constructor :129-179, _to_screen :183,
_phong :201, __call__ :232). Its three uses:

  * training: perspective projection x_pix = f X / Z + wh / 2, z = Z (no
    shift), UV-atlas textures, Phong-shaded RGB and DensePose IUV;
  * predict: orthographic x_pix = scale (W/2)(X + tx) + W/2 with z shifted by
    the batch's minimum, point-light Phong shading of per-vertex colours;
  * evaluation: with render_rgb=False (the JAX renderer's :257-291) the
    attributes are the 3 IUV channels alone and the render is IUV, depth
    and silhouettes.

The RGB colour per vertex is, in order: `verts_features`; pre-sampled
(B, 7829, 3) texels; the (B, tH, tW, 3) atlas sampled bilinearly once per
vertex (texture_mode "vertex", training's default); or, with texture_mode
"pixel", the atlas UV interpolated and the atlas sampled per pixel. The
rasterization goes through
ops/rasterizer_cuda.py: the hand-written kernels for CUDA tensors, their
plain torch version for CPU tensors. The constructor's defaults are the
JAX package's (256^2, perspective, IUV without colours); each caller
passes what its use needs.
"""

from functools import lru_cache

import numpy as np
import torch
from scipy.io import loadmat

from hp3d_bench.reference.configs import paths
from hp3d_bench.reference.ops.rasterizer_plain import rasterize


@lru_cache(maxsize=2)
def preprocess_densepose_UV(uv_path=None):
    """Load UV_Processed.mat (`uv_path`, by default the configured one) and
    compute atlas-offset UVs + per-vertex IUV.

    :return dict of numpy arrays:
        faces (13774, 3) int32 into DP vertex indexing,
        verts_map (7829,) int32 DP vertex -> SMPL vertex,
        verts_uv_offset (7829, 2) atlas UVs (6x4 grid of 24 parts),
        verts_iuv (7829, 3) [part, U, 1-V] per vertex.
    """
    DP_UV = loadmat(uv_path or paths.DP_UV_PROCESSED_FILE)
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


def _sample_texture_bilinear(tex, u, v, mask):
    """Bilinear atlas lookup. tex (B, tH, tW, 3); u/v (B, ...) in [0, 1], v
    measured up (pytorch3d style); mask (B, ...) bool. -> (B, ..., 3)"""
    B, tH, tW = tex.shape[:3]
    x = torch.clamp(u, 0.0, 1.0) * (tW - 1)
    y = (1.0 - torch.clamp(v, 0.0, 1.0)) * (tH - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, 0, tW - 1)
    y1 = torch.clamp(y0 + 1, 0, tH - 1)
    flat = tex.reshape(B, tH * tW, 3)

    def g(yy, xx):
        idx = (yy * tW + xx).reshape(B, -1, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(u.shape + (3,))

    out = ((1 - wx) * (1 - wy) * g(y0, x0) + wx * (1 - wy) * g(y0, x1)
           + (1 - wx) * wy * g(y1, x0) + wx * wy * g(y1, x1))
    return out * mask[..., None]


def _unit(v, eps=1e-9):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


class TexturedIUVRenderer:
    """Batch renderer of SMPL meshes with DensePose IUV and colours.

    The parameters after `device` are the JAX package's, with its defaults
    (its `backend`, a choice among its own rasterizers, has no counterpart).

    :param device: where the DensePose tables live (the meshes' device)
    :param img_wh: square output size
    :param projection_type: "perspective" or "orthographic"
    :param perspective_focal_length, orthographic_scale, cam_t: the
        projection's defaults (cam_t (3,), used where a call passes none)
    :param render_rgb: shade colours (A = 12 attributes per vertex, 11 with
        texture_mode "pixel"); False renders IUV, depth and silhouettes
        alone (A = 3)
    :param light_t, light_*_color: the default point light
    :param uv_path: the DensePose UV_Processed.mat (default: configs.paths)
    :param texture_mode: "vertex" or "pixel" (see the module docstring)
    """

    def __init__(self, device, img_wh=256,
                 projection_type="perspective",
                 perspective_focal_length=300.0,
                 orthographic_scale=0.9,
                 cam_t=None,
                 render_rgb=False,
                 light_t=(0.0, 0.0, -2.0),
                 light_ambient_color=(0.5, 0.5, 0.5),
                 light_diffuse_color=(0.3, 0.3, 0.3),
                 light_specular_color=(0.2, 0.2, 0.2),
                 background_color=(0.0, 0.0, 0.0),
                 uv_path=None,
                 texture_mode="vertex"):
        if projection_type not in ("perspective", "orthographic"):
            raise ValueError(f"projection_type {projection_type!r}")
        if texture_mode not in ("vertex", "pixel"):
            raise ValueError(f"texture_mode {texture_mode!r}")
        self.img_wh = img_wh
        self.render_rgb = render_rgb
        self.projection_type = projection_type
        self.focal_length = float(perspective_focal_length)
        self.orthographic_scale = orthographic_scale
        self.texture_mode = texture_mode

        def const(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.default_cam_t = const(cam_t if cam_t is not None else [0.0, 0.2, 2.5])
        self.default_lights = {
            "location": const(light_t),
            "ambient_color": const(light_ambient_color),
            "diffuse_color": const(light_diffuse_color),
            "specular_color": const(light_specular_color),
        }
        self.background_color = const(background_color)
        dp = preprocess_densepose_UV(uv_path)
        # Contiguous: the pack_faces kernel reads the rows as they lie.
        self.faces = torch.as_tensor(dp["faces"], dtype=torch.int64,
                                     device=device).contiguous()
        self.verts_map = torch.as_tensor(dp["verts_map"], dtype=torch.int64,
                                         device=device)
        self.verts_iuv = torch.as_tensor(dp["verts_iuv"], device=device)
        self.verts_uv_offset = torch.as_tensor(dp["verts_uv_offset"],
                                               device=device)

    def _to_screen(self, verts, cam_t, orthographic_scale):
        """verts (B, V, 3) + cam_t (B, 3) -> screen [x_pix, y_pix, z].

        Orthographic z is shifted by the minimum over the WHOLE batch, as in
        the JAX package, so depths match it mesh for mesh.
        """
        wh = self.img_wh
        p = verts + cam_t[:, None, :]
        if self.projection_type == "perspective":
            z = p[..., 2:3]
            return torch.cat([self.focal_length * p[..., :2] / z + wh / 2.0, z],
                             dim=-1)
        if orthographic_scale is None:
            orthographic_scale = torch.full((verts.shape[0], 2),
                                            float(self.orthographic_scale),
                                            device=verts.device)
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

    def raster_inputs(self, vertices, cam_t=None, orthographic_scale=None,
                      verts_features=None, textures=None):
        """Screen-space DensePose vertices and their attributes: A=12
        [IUV | normal | camera position | colour], A=11 with the atlas UV
        in place of the colour (texture_mode "pixel"), or A=3 [IUV] without
        render_rgb.

        :return: screen (B, 7829, 3), vert_attrs (B, 7829, A)
        """
        B = vertices.shape[0]
        if cam_t is None:
            cam_t = self.default_cam_t.expand(B, 3)
        verts_dp = vertices[:, self.verts_map, :]
        screen = self._to_screen(verts_dp, cam_t, orthographic_scale)
        attrs = [self.verts_iuv.expand((B,) + self.verts_iuv.shape)]
        if self.render_rgb:
            cam_space = verts_dp + cam_t[:, None, :]
            attrs += [_vertex_normals(cam_space, self.faces), cam_space]
            N = self.verts_uv_offset.shape[0]
            if verts_features is not None:
                attrs.append(verts_features[:, self.verts_map, :])
            elif textures.ndim == 3 and textures.shape[1] == N:
                attrs.append(textures)                # pre-sampled texels
            elif self.texture_mode == "vertex":
                uv = self.verts_uv_offset.expand(B, N, 2)
                attrs.append(_sample_texture_bilinear(
                    textures, uv[..., 0], uv[..., 1],
                    torch.ones((B, N), dtype=torch.bool, device=uv.device)))
            else:
                attrs.append(self.verts_uv_offset.expand(B, N, 2))
        return screen, torch.cat(attrs, dim=-1)

    def __call__(self, vertices, cam_t=None, orthographic_scale=None,
                 lights_rgb_settings=None, verts_features=None, textures=None):
        """Render a batch of SMPL meshes.

        :param vertices: (B, 6890, 3) SMPL-indexed vertices (camera frame)
        :param cam_t: (B, 3) camera translation (default: the constructor's)
        :param orthographic_scale: (B, 2) (default: the constructor's)
        :param lights_rgb_settings: dict location/ambient_color/
            diffuse_color/specular_color, each (B, 3) (default: the
            constructor's)
        :param verts_features: (B, 6890, 3) per-vertex RGB
        :param textures: (B, tH, tW, 3) UV atlases in [0, 1] or
            (B, 7829, 3) pre-sampled texels
        :return: dict iuv_images (B, H, W, 3), depth_images (B, H, W),
                 silhouettes (B, H, W) float32, and with render_rgb
                 rgb_images (B, H, W, 3)
        """
        B = vertices.shape[0]
        screen, vert_attrs = self.raster_inputs(vertices, cam_t,
                                                orthographic_scale,
                                                verts_features, textures)
        out = rasterize(screen, self.faces, vert_attrs, (self.img_wh, self.img_wh))
        attrs, depth, mask = out["attrs"], out["depth"], out["mask"]
        result = {
            "iuv_images": attrs[..., :3] * mask[..., None],
            "depth_images": torch.where(mask, depth, torch.zeros_like(depth)),
            "silhouettes": mask.to(torch.float32),
        }
        if self.render_rgb:
            if (verts_features is None and textures.ndim == 4
                    and self.texture_mode == "pixel"):
                uv = attrs[..., 9:11]
                texel = _sample_texture_bilinear(textures, uv[..., 0],
                                                 uv[..., 1], mask)
            else:
                texel = attrs[..., 9:12]
            lights = lights_rgb_settings or {
                k: v.expand(B, 3) for k, v in self.default_lights.items()}
            rgb = self._phong(texel, attrs[..., 3:6], attrs[..., 6:9], lights,
                              mask)
            rgb = torch.where(mask[..., None], rgb, self.background_color)
            result["rgb_images"] = torch.clamp(rgb, 0.0, 1.0)
        return result

