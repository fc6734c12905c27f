"""The hierarchy spec and its byte accounting (int8 tier).

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/hierarchy.py``.
``HierarchySpec`` is the shape contract ``kv_pool.init_pool`` consumes
(here: whether the planes hold int8 codes and scales). ``KVHierarchy``
holds the byte accounting the engine reports, over the KV planes only:

- ``flat_bytes_per_slot``: one fp plane pair, the flat-pool baseline;
- ``bytes_per_slot``: the hierarchy slot, int8 codes plus one fp32 scale
  each for k and v per (head, position) when quantizing.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Which tiers are on. Only the int8 tier is ported."""

    int8: bool = False

    @property
    def enabled(self):
        return self.int8


def spec_from_config(config):
    """InferenceConfig -> HierarchySpec."""
    return HierarchySpec(int8=bool(config.int8_kv))


class KVHierarchy(object):
    """Byte accounting of a pool whose rows are ``plane_len`` positions
    long, under ``spec`` and generation config ``gcfg``."""

    def __init__(self, spec, gcfg, plane_len):
        self.spec = spec
        self.plane_len = int(plane_len)
        hd = gcfg.n_embd // gcfg.n_head
        fp_itemsize = gcfg.dtype.itemsize
        kv_itemsize = 1 if spec.int8 else fp_itemsize
        # Bytes one cached position costs across all layers: k+v codes,
        # plus one fp32 scale each for k and v when quantizing.
        self._per_pos_bytes = gcfg.n_layer * gcfg.n_head * (
            hd * kv_itemsize * 2 + (8 if spec.int8 else 0))
        self._flat_per_pos_bytes = (gcfg.n_layer * gcfg.n_head * hd
                                    * fp_itemsize * 2)

    def bytes_per_slot(self):
        return self._per_pos_bytes * self.plane_len

    def flat_bytes_per_slot(self):
        return self._flat_per_pos_bytes * self.plane_len
