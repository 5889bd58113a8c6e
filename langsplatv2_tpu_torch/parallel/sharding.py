"""Multi-process sharding of the rasterizer and the training steps (port of
langsplatv2_tpu/parallel/sharding.py on torch.distributed).

The JAX module runs one program over a device mesh with `shard_map`; here
every rank runs the same code on its own block and meets the others in
collectives:

- Mesh axes ("data", "tile"), rank r at (r // n_tile, r % n_tile):
  cameras shard over "data" (each rank takes its own B / n_data rows of the
  camera arrays, in data-rank order: JAX's P("data") blocks), pixel tiles
  over "tile" (each rank blends a contiguous strip of ceil(T / n_tile)
  tiles against the replicated Gaussians; ids past the grid blend as
  empty). `make_gauss_mesh` is the 1-D "gauss" mesh of the
  Gaussian-sharded path (parallel/gauss_sharded.py).
- Preprocessing and binning are replicated, the XLA route's
  (`ops/binning.py::bin_gaussians`, K1 without the cull, and
  `ops/rasterize_tiles.py::blend_tiles` on the strip's tile ids).
- Gradients. JAX's shard_map transpose psums the gradients of replicated
  parameters over ("data", "tile"). Here each rank differentiates its
  partial loss (the global loss is the sum of the ranks' partial losses)
  and `reduce_gradients` all-reduces every parameter gradient over the
  mesh before the optimizer steps. The RGB loss's all-gather over "tile"
  (`distributed.gather_strips`) sums the ranks' cotangents of the gathered
  image and keeps this rank's strip, JAX's all_gather / psum_scatter pair.

The losses return (partial, loss): `partial` the rank's differentiable
term, `loss` the global value (the partials' all-reduced sum, plus the
constant 1 of the Gram loss), detached.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops import binning, projection, rasterize_tiles
from ..ops.gram import seg_to_tiles
from ..ops.rasterize import RasterizeSettings, quick_as_channels, to_f32
from ..utils import losses
from .distributed import all_reduce_, gather_strips


@dataclass
class Mesh:
    """This rank's place in a mesh of all the world's ranks: the axes'
    sizes (`shape`), its index on each (`coords`), one process group per
    axis holding the ranks that differ only on that axis (`groups`; None
    where the group is the whole world), and the device it computes on.
    Without a process group the mesh has one rank and every collective is
    the identity."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(device, rank: int) -> torch.device:
    """cuda:(LOCAL_RANK or rank) % device_count unless `device` is given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", (int(local) if local else rank)
                        % torch.cuda.device_count())


def _axis_groups(shape: tuple[int, ...], world: int) -> list[dict]:
    """For each axis, {ranks: group} over every line of the row-major grid
    along that axis; every rank creates every group, in the same order."""
    out = []
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    for a, n in enumerate(shape):
        lines = {}
        for r in range(world):
            if (r // strides[a]) % n == 0:
                ranks = tuple(r + j * strides[a] for j in range(n))
                lines[ranks] = (None if n == world
                                else dist.new_group(list(ranks)))
        out.append(lines)
    return out


def _make_mesh(names: tuple[str, ...], shape: tuple[int, ...],
               device) -> Mesh:
    rank, world = _world()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"a mesh of {shape} needs {size} ranks, the world "
                         f"has {world}")
    coords, groups = {}, {}
    if world > 1:
        for name, lines in zip(names, _axis_groups(shape, world)):
            for ranks, group in lines.items():
                if rank in ranks:
                    coords[name] = ranks.index(rank)
                    groups[name] = group
    else:
        coords = {name: 0 for name in names}
        groups = {name: None for name in names}
    return Mesh(dict(zip(names, shape)), coords, groups,
                _device(device, rank))


def make_device_mesh(n_data: int = 1, n_tile: int | None = None, *,
                     device=None) -> Mesh:
    """The ("data", "tile") mesh of the world's ranks, rank r at
    (r // n_tile, r % n_tile); n_tile defaults to world // n_data. Every
    rank calls it (it creates the axes' process groups)."""
    _rank, world = _world()
    n_tile = n_tile or world // n_data
    return _make_mesh(("data", "tile"), (n_data, n_tile), device)


def make_gauss_mesh(*, device=None) -> Mesh:
    """The 1-D "gauss" mesh of the world's ranks for the Gaussian-sharded
    path."""
    return _make_mesh(("gauss",), (_world()[1],), device)


def reduce_gradients(tensors, mesh: Mesh) -> None:
    """Sum the gradients of `tensors` over the mesh in one all-reduce (a
    missing gradient counts as zeros); the transpose of the replicated
    parameters' broadcast."""
    tensors = list(tensors)
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    if mesh.size == 1:
        return
    flat = torch.cat([t.grad.reshape(-1) for t in tensors])
    all_reduce_(flat)   # the mesh is the world
    off = 0
    for t in tensors:
        n = t.grad.numel()
        t.grad.copy_(flat[off:off + n].view_as(t.grad))
        off += n


def _padded_tile_ids(num_tiles: int, n_shards: int, device) -> torch.Tensor:
    """[n_shards * ceil(T / n_shards)] ids; those past the grid are
    num_tiles (empty tiles in blend_tiles)."""
    per = -(-num_tiles // n_shards)
    ids = torch.arange(n_shards * per, dtype=torch.int32, device=device)
    return torch.where(ids < num_tiles, ids, num_tiles)


def local_tile_ids(num_tiles: int, mesh: Mesh) -> torch.Tensor:
    """This rank's strip of `_padded_tile_ids` on the "tile" axis."""
    n = mesh.shape["tile"]
    per = -(-num_tiles // n)
    i = mesh.coords["tile"]
    return _padded_tile_ids(num_tiles, n, mesh.device)[i * per:(i + 1) * per]


def gather_tiles(t_local, mesh: Mesh, num_tiles: int):
    """The "tile" axis's strips gathered in rank order and cut to the
    grid, differentiable (`distributed.gather_strips`)."""
    full = gather_strips(t_local, mesh.groups["tile"], mesh.coords["tile"])
    return full[:num_tiles]


def rasterize_sharded(
    mesh: Mesh,
    settings: RasterizeSettings,
    means3d, opacities, viewmatrix, projmatrix, campos, bg,
    scales=None, rotations=None, cov3d_precomp=None,
    shs=None, colors_precomp=None, features=None,
    quick_weights=None, quick_indices=None, quick_channels: int = 192,
):
    """Tile-sharded render over the mesh's "tile" axis, the Gaussians
    replicated (every rank passes them all). Returns (rgb [3, H, W],
    feature_map [D, H, W] | None, radii [N], final_T [H, W]) on every
    rank, the strips all-gathered over "tile"."""
    dev = mesh.device
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    num_tiles = grid_x * grid_y
    opacities = to_f32(opacities, dev)
    proj = projection.preprocess(
        *(to_f32(x, dev) for x in (means3d, scales, rotations)),
        projection.shs_f32(shs, dev), to_f32(colors_precomp, dev),
        viewmatrix, projmatrix, campos, settings.tanfovx,
        settings.tanfovy, W, H, settings.sh_degree, settings.scale_modifier,
        cov3d_precomp=to_f32(cov3d_precomp, dev))
    if quick_weights is not None:
        feats = quick_as_channels(quick_weights, quick_indices,
                                  quick_channels, dev)
    else:
        feats = to_f32(features, dev)
    binned = binning.bin_gaussians(projection.detach(proj), grid_x, grid_y,
                                   settings.max_entries, opacities[:, 0])
    rgb_t, feat_t, t_t = rasterize_tiles.blend_tiles(
        proj.xy, proj.conic, opacities[:, 0], proj.rgb, feats, binned,
        grid_x, grid_y, to_f32(bg, dev), settings.tile_cap,
        settings.tile_batch, tile_ids=local_tile_ids(num_tiles, mesh))
    img = lambda t: rasterize_tiles.tiles_to_image(  # noqa: E731
        gather_tiles(t, mesh, num_tiles), grid_x, grid_y, H, W)
    feature_map = img(feat_t) if feat_t is not None else None
    return img(rgb_t), feature_map, proj.radius, img(t_t[..., None])[0]


def _render_strip(settings, model, view, proj_m, campos, bg, features,
                  tile_ids, sh_degree: int, scale_modifier: float,
                  dummy=None):
    """One camera's strip on the XLA route: the preprocess of the model,
    the means2D carrier when `dummy` is given, bin_gaussians and the
    autograd blend of `tile_ids`. Returns (rgb_t, feat_t, radius)."""
    H, W = settings.image_height, settings.image_width
    proj = projection.preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_features(), None, view, proj_m, campos, settings.tanfovx,
        settings.tanfovy, W, H, sh_degree, scale_modifier)
    xy = proj.xy
    if dummy is not None:
        scale = torch.tensor([0.5 * W, 0.5 * H], device=xy.device)
        xy = xy + dummy * scale
    op = model.get_opacity()[:, 0]
    binned = binning.bin_gaussians(projection.detach(proj), settings.grid_x,
                                   settings.grid_y, settings.max_entries,
                                   op)
    rgb_t, feat_t, _ = rasterize_tiles.blend_tiles(
        xy, proj.conic, op, proj.rgb, features, binned, settings.grid_x,
        settings.grid_y, bg, settings.tile_cap, settings.tile_batch,
        tile_ids=tile_ids)
    return rgb_t, feat_t, proj.radius


def _global(partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_reduce_(partial.detach().clone())   # over the world = mesh


def _image_to_tiles(img, grid_x: int, grid_y: int):
    """[C, H, W] -> [num_tiles, 256, C], zero-padded to the tile grid."""
    B = projection.BLOCK
    C, H, W = img.shape
    img = torch.nn.functional.pad(img, (0, grid_x * B - W, 0, grid_y * B - H))
    img = img.reshape(C, grid_y, B, grid_x, B)
    return img.permute(1, 3, 2, 4, 0).reshape(grid_y * grid_x, B * B, C)


def make_sharded_feature_loss(mesh: Mesh, settings: RasterizeSettings,
                              topk: int, layer_idx: int = 0,
                              use_cos_loss: bool = True,
                              use_l1_loss: bool = False):
    """The pixel-space feature loss, tile- and data-sharded: loss(model,
    views, projs, camposs, bg, gt_feats [B_local, 512, H, W], gt_masks
    [B_local, 1, H, W]) -> (partial, loss), loss the camera mean of the
    reference's cos (and l1) loss over the image."""
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    num_tiles = grid_x * grid_y
    n_data = mesh.shape["data"]
    ids = local_tile_ids(num_tiles, mesh)
    safe = torch.clamp(ids, max=num_tiles - 1).long()
    in_range = (ids < num_tiles).float()

    def loss_one_camera(model, view, proj_m, campos, bg, gt_feat, gt_mask):
        _, feat_t, _ = _render_strip(
            settings, model, view, proj_m, campos, bg,
            model.get_render_weights(topk), ids, model.active_sh_degree,
            1.0)
        L, K, D = model.codebooks.shape
        flat = feat_t.reshape(-1, L * K)
        feat = None
        for i in range(layer_idx + 1):
            layer = flat[:, i * K:(i + 1) * K] @ model.codebooks[i]
            if feat is not None:
                layer = layer + feat.detach()
            feat = layer                                     # [T_local*P, D]
        gt_local = _image_to_tiles(gt_feat, grid_x, grid_y)[safe].reshape(
            -1, D)
        m_local = (_image_to_tiles(gt_mask.float(), grid_x, grid_y)[safe][
            ..., 0] * in_range[:, None]).reshape(-1)
        # In-image pixels: the padding of edge tiles is left out, so the
        # shards' sum is the single-device mean over H * W.
        ones = torch.ones((1, H, W), device=feat.device)
        valid = (_image_to_tiles(ones, grid_x, grid_y)[safe][..., 0]
                 * in_range[:, None]).reshape(-1)
        pn = losses.safe_norm(feat * m_local[:, None], dim=1)
        gn = losses.safe_norm(gt_local * m_local[:, None], dim=1)
        sim = (feat * gt_local).sum(1) * (m_local ** 2) / (pn * gn)
        count = float(H * W)
        total = torch.zeros((), device=feat.device)
        if use_cos_loss:
            total = total + (valid * (1.0 - sim)).sum() / count
        if use_l1_loss:
            l1_sum = ((feat - gt_local).abs() * m_local[:, None]
                      * valid[:, None]).sum()
            total = total + l1_sum / (count * D)
        return total

    def loss(model, views, projs, camposs, bg, gt_feats, gt_masks):
        dev = mesh.device
        bg = to_f32(bg, dev)
        b_local = len(views)
        per_cam = sum(loss_one_camera(
            model, to_f32(views[b], dev), to_f32(projs[b], dev),
            to_f32(camposs[b], dev), bg, to_f32(gt_feats[b], dev),
            torch.as_tensor(gt_masks[b], device=dev))
            for b in range(b_local))
        partial = per_cam / (b_local * n_data)
        return partial, _global(partial, mesh)

    return loss


def make_sharded_gram_loss(mesh: Mesh, settings: RasterizeSettings,
                           topk: int, layer_idx: int = 0):
    """The Gram-space cosine loss, tile- and data-sharded (trainer's
    gram_cos_loss on each rank's strip): loss(model, views, projs, camposs,
    bg, gt_tables [B_local, S, 512], seg_maps [B_local, H, W]) -> (partial,
    loss). Each rank sums its pixels' sims (_gram_cos_core, reduce="sum");
    loss = 1 - (the sum over ranks) / (B * H * W), linear in the sims, so
    the gradients are the single-device ones."""
    from ..train.trainer import _gram_cos_core

    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    num_tiles = grid_x * grid_y
    n_data = mesh.shape["data"]
    ids = local_tile_ids(num_tiles, mesh)
    safe = torch.clamp(ids, max=num_tiles - 1).long()
    in_range = ids < num_tiles
    P = rasterize_tiles.P

    def sim_sum_one_camera(model, view, proj_m, campos, bg, gt_table,
                           seg_map):
        _, feat_t, _ = _render_strip(
            settings, model, view, proj_m, campos, bg,
            model.get_render_weights(topk), ids, model.active_sh_degree,
            1.0)
        L, K, _D = model.codebooks.shape
        # Off-grid tiles and the padding of edge tiles carry -1 (sim 0).
        seg_local = torch.where(in_range[:, None],
                                seg_to_tiles(seg_map, grid_x, grid_y)[safe],
                                -1)
        w = feat_t.reshape(ids.shape[0] * P, L, K).permute(1, 2, 0)
        return _gram_cos_core(model.codebooks, w, seg_local.reshape(-1),
                              H * W, layer_idx, eps=1e-8, gt_table=gt_table,
                              reduce="sum")

    def loss(model, views, projs, camposs, bg, gt_tables, seg_maps):
        dev = mesh.device
        bg = to_f32(bg, dev)
        b_local = len(views)
        sim = sum(sim_sum_one_camera(
            model, to_f32(views[b], dev), to_f32(projs[b], dev),
            to_f32(camposs[b], dev), bg, to_f32(gt_tables[b], dev),
            torch.as_tensor(seg_maps[b], device=dev).to(torch.int32))
            for b in range(b_local))
        partial = -sim / (b_local * n_data * H * W)
        return partial, 1.0 + _global(partial, mesh)

    return loss


def make_sharded_feature_train_step(
    mesh: Mesh,
    settings: RasterizeSettings,
    optimizer: torch.optim.Optimizer,
    topk: int,
    layer_idx: int = 0,
    use_cos_loss: bool = True,
    use_l1_loss: bool = False,
    loss_space: str | None = None,
):
    """The feature step with cameras over "data" and tiles over "tile".
    loss_space (default "gram" for the cosine-only loss, else "pixel"):
    "gram" takes (gt_a, gt_b) = (segment tables [B_local, S, 512], segment
    maps [B_local, H, W]), "pixel" (features [B_local, 512, H, W], masks
    [B_local, 1, H, W]). Returns step(model, views, projs, camposs, bg,
    gt_a, gt_b) -> {"loss": the global loss}: the partial loss's backward,
    the logits' and codebooks' gradients summed over the mesh, Adam
    (`optimizer` over trainer.feature_params(model)). The model is updated
    in place."""
    from ..train.trainer import feature_params

    if loss_space is None:
        loss_space = "gram" if (use_cos_loss and not use_l1_loss) else "pixel"
    if loss_space == "gram":
        if not use_cos_loss or use_l1_loss:
            raise ValueError("the gram loss space implements the cosine "
                             "loss only")
        sharded_loss = make_sharded_gram_loss(mesh, settings, topk,
                                              layer_idx)
    elif loss_space == "pixel":
        sharded_loss = make_sharded_feature_loss(
            mesh, settings, topk, layer_idx, use_cos_loss, use_l1_loss)
    else:
        raise ValueError(f"unknown loss_space {loss_space!r}")

    def step(model, views, projs, camposs, bg, gt_a, gt_b):
        params = feature_params(model)
        optimizer.zero_grad(set_to_none=False)
        partial, loss = sharded_loss(model, views, projs, camposs, bg, gt_a,
                                     gt_b)
        partial.backward()
        reduce_gradients(params.values(), mesh)
        optimizer.step()
        return {"loss": loss}

    return step


def make_sharded_rgb_loss(mesh: Mesh, settings: RasterizeSettings,
                          lambda_dssim: float):
    """The RGB loss, tile- and data-sharded: loss(model, dummy [N, 2],
    views, projs, camposs, bg, gts [B_local, 3, H, W]) -> (partial, loss,
    l1, radii [B_local, N]). Each rank blends its strip, the strips are
    gathered over "tile" so that SSIM's window sees the whole image, and
    the loss is the camera mean of (1 - lambda) L1 + lambda (1 - SSIM);
    `dummy` is the means2D carrier (zeros; its gradient is what
    densification reads)."""
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    num_tiles = grid_x * grid_y
    n_tile, n_data = mesh.shape["tile"], mesh.shape["data"]
    ids = local_tile_ids(num_tiles, mesh)

    def loss(model, dummy, views, projs, camposs, bg, gts):
        dev = mesh.device
        bg = to_f32(bg, dev)
        loss_sum = l1_sum = 0.0
        radii = []
        b_local = len(views)
        for b in range(b_local):
            rgb_t, _, radius = _render_strip(
                settings, model, to_f32(views[b], dev),
                to_f32(projs[b], dev), to_f32(camposs[b], dev), bg, None,
                ids, model.active_sh_degree, settings.scale_modifier, dummy)
            rgb = rasterize_tiles.tiles_to_image(
                gather_tiles(rgb_t, mesh, num_tiles), grid_x, grid_y, H, W)
            gt = to_f32(gts[b], dev)
            l1 = losses.l1_loss(rgb, gt)
            loss_sum = loss_sum + (1.0 - lambda_dssim) * l1 + \
                lambda_dssim * (1.0 - losses.ssim(rgb, gt))
            l1_sum = l1_sum + l1.detach()
            radii.append(radius)
        # Every tile rank of a data row has the whole image's loss: the
        # divisor n_tile makes the ranks' sum the camera mean, and the
        # gather's backward sends each strip its share once.
        denom = b_local * n_data * n_tile
        partial = loss_sum / denom
        return (partial, _global(partial, mesh), _global(l1_sum / denom,
                                                         mesh),
                torch.stack(radii))

    return loss


def make_sharded_rgb_train_step(mesh: Mesh, settings: RasterizeSettings,
                                optimizer: torch.optim.Optimizer,
                                lambda_dssim: float):
    """The geometry step with cameras over "data" and tiles over "tile".
    Returns step(model, views, projs, camposs, bg, gt_images) -> metrics
    (loss, l1, num_visible), the model updated in place: the partial
    loss's backward, every gradient and the means2D carrier's summed over
    the mesh, dead (padding) rows' gradients zeroed, the scheduled rates,
    Adam (`optimizer` from trainer.make_rgb_optimizer), then the
    densification statistics over the whole camera batch (B = n_data *
    B_local): max_radii2d takes the batch max of the radii,
    xyz_gradient_accum grows by the norm of the batch-summed viewspace
    gradient where a camera sees the Gaussian, denom by the count of
    cameras that see it. At B = 1 this is trainer.rgb_step."""
    from ..train.optimizers import set_scheduled_lrs
    from ..train.trainer import rgb_params

    sharded_loss = make_sharded_rgb_loss(mesh, settings, lambda_dssim)
    data_group = mesh.groups["data"]

    def step(model, views, projs, camposs, bg, gt_images):
        params = rgb_params(model)
        dummy = torch.zeros((model.capacity, 2), device=model.xyz.device,
                            requires_grad=True)
        optimizer.zero_grad(set_to_none=False)
        partial, loss, l1, radii = sharded_loss(
            model, dummy, views, projs, camposs, bg, gt_images)
        partial.backward()
        reduce_gradients([*params.values(), dummy], mesh)
        dead = ~model.live
        for p in params.values():
            p.grad.masked_fill_(dead.reshape((-1,) + (1,) * (p.dim() - 1)),
                                0.0)
        set_scheduled_lrs(optimizer)
        optimizer.step()
        with torch.no_grad():
            vis_b = radii > 0                                 # [B_local, N]
            vis_any = all_reduce_(vis_b.any(0).to(torch.int32), data_group,
                                  dist.ReduceOp.MAX) > 0
            rad_max = all_reduce_(radii.float().amax(0), data_group,
                                  dist.ReduceOp.MAX)
            seen = all_reduce_(vis_b.sum(0).float(), data_group)
            model.max_radii2d.copy_(torch.where(
                vis_any, torch.maximum(model.max_radii2d, rad_max),
                model.max_radii2d))
            model.xyz_gradient_accum.add_(torch.where(
                vis_any[:, None],
                torch.linalg.norm(dummy.grad[:, :2], dim=-1, keepdim=True),
                0.0))
            model.denom.add_(seen[:, None])
        return {"loss": loss, "l1": l1, "num_visible": vis_any.sum()}

    return step
