"""Helpers for running sparse attention inside existing models: padding
sequences to block multiples and building sparse attention layers.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``
(reference ``deepspeed/ops/sparse_attention/sparse_attention_utils.py``).
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.bert_sparse_self_attention \
    import BertSparseSelfAttention


class SparseAttentionUtils:
    """Static helpers with the reference class's surface."""

    @staticmethod
    def extend_position_embedding(params, max_position):
        """Tile a learned position-embedding table out to ``max_position``
        rows (or cut it to them), returning a new table. ``params`` is the
        table itself or a dict holding it under ``'embedding'`` (a flax
        ``nn.Embed`` layout; the dict returned is a copy)."""
        def extend(table):
            table = torch.as_tensor(table)
            orig = table.shape[0]
            if max_position <= orig:
                return table[:max_position]
            reps = -(-max_position // orig)
            return table.repeat(reps, 1)[:max_position]

        if isinstance(params, dict):
            out = dict(params)
            out["embedding"] = extend(params["embedding"])
            return out
        return extend(params)

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Set a HF tokenizer's ``model_max_length`` to the extended
        position embedding's length."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position, sparsity_config=None):
        """Swap the model's attention for the block-sparse one, in place
        (``module_inject.replace_attn_with_sparse``, where the contract
        is); returns the model."""
        from deepspeed_tpu_torch.module_inject import replace_attn_with_sparse
        return replace_attn_with_sparse(model, max_position, sparsity_config)

    @staticmethod
    def replace_self_attention_layer_with_sparse_self_attention_layer(
            config, layers, sparsity_config=None, device=None):
        """A ``BertSparseSelfAttention`` replacement for each given layer."""
        return [BertSparseSelfAttention(config, sparsity_config, device)
                for _ in layers]

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask,
                          token_type_ids, position_ids, inputs_embeds,
                          pad_token_id, model_embeddings):
        """Pad token, mask and embedding inputs along the sequence to a
        multiple of ``block_size``. Returns (pad_len, input_ids,
        attention_mask, token_type_ids, position_ids, inputs_embeds), each
        padded or passed through as None: ids and position ids with
        ``pad_token_id``, the mask and token types with 0, the embeddings
        with ``model_embeddings`` of pad ids."""
        if input_ids is not None:
            seq_len = input_ids.shape[1]
        else:
            seq_len = inputs_embeds.shape[-2]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len > 0:
            if inputs_embeds is not None:
                pad_ids = torch.full((inputs_embeds.shape[0], pad_len),
                                     pad_token_id, dtype=torch.long,
                                     device=inputs_embeds.device)
                inputs_embeds = torch.cat(
                    [inputs_embeds, model_embeddings(pad_ids)], dim=-2)

            def pad(x, value):
                return None if x is None else F.pad(x, (0, pad_len),
                                                    value=value)

            input_ids = pad(input_ids, pad_token_id)
            position_ids = pad(position_ids, pad_token_id)
            attention_mask = pad(attention_mask, 0)
            token_type_ids = pad(token_type_ids, 0)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Strip the padding ``pad_to_block_size`` added."""
        if pad_len > 0:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output
