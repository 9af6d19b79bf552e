"""JSON → model factories, mirroring tcnn's ``create_encoding`` /
``create_network`` / ``create_loss`` / ``create_optimizer`` (reference usage:
``src/testbed.cu:4007-4110``), so the reference's shipped ``configs/*/*.json``
drive this framework unchanged.
"""

from __future__ import annotations

from typing import Any, Callable

from ngp_tpu.models.encodings import (
    CompositeEncoding,
    Encoding,
    FrequencyEncoding,
    GridEncoding,
    IdentityEncoding,
    OneBlobEncoding,
    SphericalHarmonicsEncoding,
    TriangleWaveEncoding,
)
from ngp_tpu.models.mlp import MLP
from ngp_tpu.models.nerf_network import NerfNetwork
from ngp_tpu.ops.losses import get_loss


def create_encoding(n_input_dims: int, cfg: dict, octree=None) -> Encoding:
    otype = cfg.get("otype", "Identity").lower()
    if otype == "takikawa":
        from ngp_tpu.models.takikawa import TakikawaEncoding

        if octree is None:
            raise ValueError(
                "Takikawa encoding needs a TriangleOctree (built from the "
                "scene mesh, reference testbed.cu:4082-4098)"
            )
        return TakikawaEncoding(
            octree=octree,
            starting_level=cfg.get("starting_level", 0),
            n_features_per_level=cfg.get("n_features_per_level", 2),
            sum_instead_of_concat=cfg.get("sum_instead_of_concat", False),
        )
    if otype in ("hashgrid", "densegrid", "tiledgrid", "grid"):
        grid_type = {
            "hashgrid": "Hash",
            "densegrid": "Dense",
            "tiledgrid": "Tiled",
        }.get(otype, cfg.get("type", "Hash"))
        return GridEncoding(
            n_input_dims=n_input_dims,
            n_levels=cfg.get("n_levels", 16),
            n_features_per_level=cfg.get("n_features_per_level", 2),
            log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
            base_resolution=cfg.get("base_resolution", 16),
            per_level_scale=cfg.get("per_level_scale", 2.0),
            grid_type=grid_type,
            interpolation=cfg.get("interpolation", "Linear"),
            # "additive" unlocks the corner-dup gather fast path; "tcnn" is
            # the reference's XOR hash (bit-exact .ingp interop).
            hash_variant=cfg.get("hash_variant", "tcnn"),
            gather_dtype=cfg.get("gather_dtype", "float32"),
            dup_gather_dtype=cfg.get("dup_gather_dtype", "packed_bf16"),
        )
    if otype == "sphericalharmonics":
        return SphericalHarmonicsEncoding(
            n_input_dims=n_input_dims, degree=cfg.get("degree", 4)
        )
    if otype == "identity":
        return IdentityEncoding(
            n_input_dims=n_input_dims,
            scale=cfg.get("scale", 1.0),
            offset=cfg.get("offset", 0.0),
        )
    if otype == "frequency":
        return FrequencyEncoding(
            n_input_dims=n_input_dims, n_frequencies=cfg.get("n_frequencies", 12)
        )
    if otype == "trianglewave":
        return TriangleWaveEncoding(
            n_input_dims=n_input_dims, n_frequencies=cfg.get("n_frequencies", 12)
        )
    if otype == "oneblob":
        return OneBlobEncoding(
            n_input_dims=n_input_dims, n_bins=cfg.get("n_bins", 16)
        )
    if otype == "composite":
        nested_cfgs = cfg["nested"]
        nested, remaining = [], n_input_dims
        for i, sub in enumerate(nested_cfgs):
            nd = sub.get("n_dims_to_encode", None)
            if nd is None:
                nd = remaining - sum(
                    s.get("n_dims_to_encode", 0) for s in nested_cfgs[i + 1 :]
                )
            nested.append((create_encoding(nd, sub), nd))
            remaining -= nd
        return CompositeEncoding(nested=nested)
    raise ValueError(f"unknown encoding otype {cfg.get('otype')!r}")


def create_network(n_input_dims: int, n_output_dims: int, cfg: dict) -> MLP:
    otype = cfg.get("otype", "FullyFusedMLP").lower()
    if otype not in ("fullyfusedmlp", "cutlassmlp", "megakernelmlp", "mlp"):
        raise ValueError(f"unknown network otype {cfg.get('otype')!r}")
    return MLP(
        n_input_dims=n_input_dims,
        n_output_dims=n_output_dims,
        n_neurons=cfg.get("n_neurons", 64),
        n_hidden_layers=cfg.get("n_hidden_layers", 2),
        activation=cfg.get("activation", "ReLU"),
        output_activation=cfg.get("output_activation", "None"),
    )


def create_loss(cfg: dict) -> Callable:
    return get_loss(cfg.get("otype", "L2"))


def create_optimizer(cfg: dict, grid_label_fn=None):
    from ngp_tpu.optim import make_optimizer

    return make_optimizer(cfg, grid_label_fn)


class NetworkWithInputEncoding:
    """Encoding → MLP composition, the tcnn ``NetworkWithInputEncoding`` used
    by the image/SDF/volume modes (reference ``src/testbed.cu:4101-4110``)."""

    def __init__(self, encoding: Encoding, network: MLP):
        self.encoding = encoding
        self.network = network

    @classmethod
    def from_config(
        cls, n_input_dims: int, n_output_dims: int, cfg: dict, octree=None
    ) -> "NetworkWithInputEncoding":
        enc = create_encoding(n_input_dims, cfg["encoding"], octree=octree)
        net = create_network(enc.n_output_dims, n_output_dims, cfg["network"])
        return cls(enc, net)

    def init(self, key):
        import jax

        k1, k2 = jax.random.split(key)
        return {"encoding": self.encoding.init(k1), "network": self.network.init(k2)}

    def __call__(self, params, x):
        return self.network(params["network"], self.encoding(params["encoding"], x))

    @property
    def n_params(self) -> int:
        return self.encoding.n_params + self.network.n_params


def create_network_with_input_encoding(
    n_input_dims: int, n_output_dims: int, cfg: dict, octree=None
) -> NetworkWithInputEncoding:
    return NetworkWithInputEncoding.from_config(
        n_input_dims, n_output_dims, cfg, octree=octree
    )


def create_nerf_network(cfg: dict, n_extra_dims: int = 0) -> NerfNetwork:
    """Build the two-stage NeRF network from a reference-format config
    (sections ``encoding``/``network``/``dir_encoding``/``rgb_network``),
    mirroring ``NerfNetwork``'s constructor (``nerf_network.h:81-113``)."""
    pos_enc = create_encoding(3, cfg["encoding"])
    dir_enc = create_encoding(3 + n_extra_dims, cfg["dir_encoding"])
    density_cfg = dict(cfg["network"])
    density_out = density_cfg.get("n_output_dims", 16)
    density_mlp = create_network(pos_enc.n_output_dims, density_out, density_cfg)
    rgb_in = density_out + dir_enc.n_output_dims
    rgb_mlp = create_network(rgb_in, 3, cfg["rgb_network"])
    return NerfNetwork(
        pos_encoding=pos_enc,
        dir_encoding=dir_enc,
        density_mlp=density_mlp,
        rgb_mlp=rgb_mlp,
    )
