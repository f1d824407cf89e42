from nr3d_lib_tpu.ops.lotd import (  # noqa: F401
    LoDMeta, LoDType, generate_meta, lotd_encode, lotd_fwd_dydx, lotd_bwd_dydx)
from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_encoding import LoTDEncoding  # noqa: F401
from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_cfg import (  # noqa: F401
    get_lotd_cfg, auto_ngp_cfg)
from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_brick_encoding import LoTDBrickEncoding  # noqa: F401,E501


def get_lotd_encoding(input_ch: int = 3, *, backend: str = "xla",
                      lotd_cfg=None, hashmap_rows: int = 4096, seed: int = 0,
                      **kwargs):
    """Encoding factory shared by the field classes: backend 'xla' →
    LoTDEncoding (all 8 decomposition types, all autodiff orders);
    'brick' → LoTDBrickEncoding (Dense/Hash brick rows)."""
    if backend == "brick":
        lc = dict(lotd_cfg or {})
        types = lc.get("lod_types", "Dense")
        if isinstance(types, str):
            types = [types] * len(lc["lod_res"])
        # lod_n_feats=4 selects the bf16 variant (ops/lotd_brick4.py)
        enc = LoTDBrickEncoding(input_ch, lod_res=lc["lod_res"],
                                lod_types=types, hashmap_rows=hashmap_rows,
                                n_feats=int(lc.get("lod_n_feats", 2)),
                                seed=seed)
        enc.set_anneal_iter = lambda it: None
        return enc
    return LoTDEncoding(input_ch, lotd_cfg=lotd_cfg, seed=seed, **kwargs)
