"""Time the port's flash-decode kernels (K3-K6), flash-attention kernels
(K1, K2a, K2b) and block-sparse attention kernels (K7a, K7b) of two
checkouts on one card, in turns: A, B, B, A.

    python3 compare_trees.py DIR_A DIR_B [--out FILE] [--serving]

Each DIR is the root of a checkout (for instance a ``git archive`` of the
parent commit unpacked under ``build/``). Each turn runs in a fresh process
from that checkout: it builds the checkout's kernels (``chip_smoke.
phase_build``), then times, with that checkout's ``chip_smoke`` (CUDA-event
medians):

- K3, K4, K5 and K6 (``_variant``: the dense, int8, paged and paged int8
  cases of the serving path, pages of 128), K3's plain version and torch's
  scaled_dot_product_attention with a bool mask (K3's yardstick, on
  ``_case``'s planes) at the serving decode case (B=16, H=16, S=1,
  frontiers ``DECODE_POS``, bf16) and the prefill lane's (B=1, S=32,
  frontier 500);
- K1, K2a and K2b, their plain versions and torch's
  scaled_dot_product_attention (``_flash_times``) at GPT-2 medium
  training's shape (B=8, H=16, T=1024, D=64, bf16, causal) and at
  BERT-large's (B=16, T=512, non-causal, padding mask), and K2b's dq kernel
  alone (``dq_ms``, launched through the same C entry point in both trees);
- K7a, K7b fused and K7b split, their plain versions and SDPA with the
  layout as a dense mask (``_sparse_times``) at the sparse BERT path's
  shape (B=2, H=16, T=4096, D=64, bf16, the Fixed layout at block 64,
  padding mask; ``_sparse_inputs``, ``_sparse_layout``, ``lower``).

With ``--serving`` each turn instead builds the checkout's flash-decode
library, then serves GPT-2 medium (bf16, seeded weights) with that
checkout's ``chip_smoke.phase_serve`` on its first two serving paths (the
dense pool and the paged int8 pool, each followed by its profiler window),
and returns their ``serve*`` and ``profile*`` lines: the engine's step as
each checkout runs it (eager, or replayed CUDA graphs).

Prints one JSON line per turn and, last, the card's name and power limit;
with ``--out``, writes the turns there as a JSON list.
"""

import argparse
import json
import os
import subprocess
import sys

# Run inside each checkout: the same calls exist in every chip_smoke.py
# since the flash kernels landed.
_TURN = r"""
import json, sys, torch
import torch.nn.functional as F
import chip_smoke as c
c.phase_env()
c.phase_build()
at, sk, da = c.at, c.sk, c.da


# K2b's dq kernel on its own, launched here through its C entry point (the
# same in both trees) so that both trees are timed by the same code.
def dq_kernel(q, k, v, do, mask, lse, delta, causal):
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), at._ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, H, T, T, D, at._DTYPE_CODE[q.dtype], D ** -0.5, int(causal),
            at._stream(q))
    return lambda: at._raise_on(at._kernel("ds_flash_bwd_dq")(*args), "dq")


# K3-K6, K3's plain version and SDPA with a bool mask, bf16.
def decode_times(B, S, frontiers):
    row = {}
    for kind, label in (("decode", "K3"), ("q8", "K4"), ("paged", "K5"),
                        ("paged_q8", "K6")):
        case = c._variant(kind, B, S, frontiers, torch.bfloat16, seed=0)
        row[label] = c.cuda_ms(case["kernel"])
        if kind == "decode":
            row["K3_plain"] = c.cuda_ms(case["plain"])
        del case
    q, k, v, pos = c._case(B, S, frontiers, torch.bfloat16, seed=0)
    key = torch.arange(k.shape[2], device="cuda")
    row_pos = pos.long()[:, None] + torch.arange(S, device="cuda")[None]
    mask = (key[None, None, :] <= row_pos[:, :, None])[:, None]
    row["sdpa_bool_mask"] = c.cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=0.125))
    return row


out = {"decode": decode_times(16, 1, c.DECODE_POS),
       "prefill_lane": decode_times(1, 32, [500])}
for name, B, T, causal, masked, seed in (
        ("gpt2", 8, 1024, True, False, 0),
        ("bert", c.BERT_B, c.BERT_T, False, "padding", 1)):
    q, k, v, do, mask = c._flash_inputs(B, T, torch.bfloat16, masked, seed)
    o, lse = at.flash_fwd(q, k, v, mask, causal)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    out[name] = c._flash_times(q, k, v, do, mask, lse, delta, causal)
    out[name]["dq_ms"] = c.cuda_ms(dq_kernel(q, k, v, do, mask, lse, delta,
                                             causal))
    del q, k, v, do, mask, o, lse, delta
q, k, v, do, kw = c._sparse_inputs(c.SPARSE_B, c.SPARSE_T, torch.bfloat16,
                                   "padding", None, 20)
kw["causal"] = False
lowered = sk.lower(c._sparse_layout("fixed", c.SPARSE_BLOCK, c.SPARSE_T, 20),
                   c.SPARSE_BLOCK)
o, lse = sk.sparse_fwd(q, k, v, lowered, **kw)
delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
out["sparse"] = c._sparse_times(q, k, v, do, lowered, lse, delta, kw)
print("TURN " + json.dumps(out))
"""


# The serving turn: the lines phase_serve and phase_profile print.
_SERVE_TURN = r"""
import json, torch
import chip_smoke as c
from deepspeed_tpu_torch.op_builder import load
card = c.phase_env()
load("decode_attention")
model = c.GPT2LMHeadModel(c.GPT2Config.gpt2_medium(dtype=torch.bfloat16),
                          device="cuda", seed=0)
for path in c.SERVE_PATHS[:2]:
    c.phase_serve(card, model, *path)
"""


def _serve_lines(stdout):
    """The ``serve*`` and ``profile*`` lines of a serving turn, by label."""
    out = {}
    for line in stdout.splitlines():
        label, _, rest = line.partition(" ")
        if label.startswith(("serve", "profile")) and rest.startswith("{"):
            out[label] = json.loads(rest)
    return out


def _turn(tree, serving=False):
    tree = os.path.abspath(tree)
    code = _SERVE_TURN if serving else _TURN
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                          env=dict(os.environ, PYTHONPATH=tree),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit("compare_trees: the turn in {} failed".format(tree))
    if serving:
        return _serve_lines(proc.stdout)
    line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")][-1]
    return json.loads(line[5:])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("tree_a")
    parser.add_argument("tree_b")
    parser.add_argument("--out")
    parser.add_argument("--serving", action="store_true")
    args = parser.parse_args()
    turns = []
    for label, tree in (("A", args.tree_a), ("B", args.tree_b),
                        ("B", args.tree_b), ("A", args.tree_a)):
        times = _turn(tree, args.serving)
        turns.append({"tree": label, "dir": tree, "times": times})
        print(json.dumps(turns[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(turns, f, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
