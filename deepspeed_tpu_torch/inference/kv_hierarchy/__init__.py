"""deepspeed_tpu_torch.inference.kv_hierarchy: the KV memory tiers.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/``. Three tiers
behind the slot-pool contract (no program added by any tier, greedy
streams unchanged, crash-only recovery intact):

- **Shared-prefix cache** (prefix_cache.py): a host-side radix trie over
  prompt token ids finds a shared prefix at admission. On a dense pool the
  matched span of the stored prefix row (``pk``/``pv`` planes) is COPIED
  into the slot's own plane at admission, in place, and prefill starts past
  it; the JAX package selects per position between the two planes at every
  decode step instead, and the slot's plane after the copy is elementwise
  what that select reads. On a paged pool the row's full pages are shared
  into the slot's block table (the straddle page copy-on-write).
- **int8 KV** (quant.py; kernels K4 and K6): int8 codes with fp32
  per-(head, position) scales.
- **Host offload** (offload.py): idle sessions' slots swap to host memory
  as captured records and restore on resume, driven by the scheduler's
  ``swapped`` phase. Every transfer is an eager op outside the captured
  step programs.

``hierarchy.py`` ties them together: ``HierarchySpec`` (the pool-shape
contract ``init_pool`` consumes), ``spec_from_config`` and the
``KVHierarchy`` the engine drives (on_admit / on_prefill_done /
on_release / reset, the swap store, the byte accounting). Everything
host-side here is derived state: ``reset()`` drops it all and the request
records rebuild the streams.

The serving fleet's pieces: ``prefix_directory.py`` (which replica holds
which shared prefix: the router's affinity and the adoption path) and
offload.py's transports (a step's handoff captures in one
synchronization, prefix rows shipped between replicas). A handoff record
carries the slot's aliased prefix span by value (a dense slot holds its
copied span, a paged record every live page), so the acceptor needs no
prefix row of its own: the JAX package's ``on_handoff_in`` pin and the
prefix ship ahead of a handoff have no counterpart here.
"""

from deepspeed_tpu_torch.inference.kv_hierarchy.hierarchy import (  # noqa: F401
    HierarchySpec,
    KVHierarchy,
    spec_from_config,
)
from deepspeed_tpu_torch.inference.kv_hierarchy.offload import (  # noqa: F401
    HostSwapStore,
    capture_prefix_pages,
    capture_prefix_row,
    capture_slot,
    capture_slot_paged,
    capture_slots,
    capture_slots_paged,
    pick_swap_victim,
    record_nbytes,
    restore_prefix_pages,
    restore_prefix_row,
    restore_slot,
    restore_slot_paged,
)
from deepspeed_tpu_torch.inference.kv_hierarchy.prefix_cache import (  # noqa: F401,E501
    PrefixStore,
    RadixTrie,
)
from deepspeed_tpu_torch.inference.kv_hierarchy.prefix_directory import (  # noqa: F401,E501
    PrefixDirectory,
)
from deepspeed_tpu_torch.inference.kv_hierarchy.quant import (  # noqa: F401
    dequantize_kv,
    quantize_kv,
)
