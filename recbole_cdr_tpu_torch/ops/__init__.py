"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and runs the plain PyTorch version for CPU tensors), the plain version, and
a ``launches`` count on the wrapper that grows by one per kernel launch.
"""

from recbole_cdr_tpu_torch.ops import (
    benchmark_topk,
    candidate_topk,
    conet_tower,
    deepapf_attention,
    gather_dot,
    graph_layer,
    masked_topk,
    natr_attention,
    neg_sampler,
    rank_sum,
    rating_vector,
    row_groups,
    shuffle,
    sparse_adam,
    topk,
)

#: kernel name -> wrapper carrying its launch count
WRAPPERS = {
    "gather_dot_forward": gather_dot.gather_dot_forward,
    "gather_dot_backward": gather_dot.gather_dot_backward,
    "neg_sampler": neg_sampler.sample_negatives,
    "swap_or_not": shuffle.swap_or_not,
    "masked_topk": masked_topk.masked_topk,
    "streaming_topk": topk.streaming_topk,
    "sparse_adam": sparse_adam.sparse_adam,
    "graph_layer_forward": graph_layer.graph_layer_forward,
    "graph_layer_backward": graph_layer.graph_layer_backward,
    "rank_sum": rank_sum.rank_sum,
    "natr_attention_forward": natr_attention.natr_attention_forward,
    "natr_attention_backward": natr_attention.natr_attention_backward,
    "natr_anchor_table": natr_attention.natr_anchor_table,
    "natr_pair_grid": natr_attention.natr_pair_grid,
    "rating_vector_forward": rating_vector.rating_vector_forward,
    "rating_vector_backward": rating_vector.rating_vector_backward,
    "candidate_topk": candidate_topk.candidate_topk,
    "rank_sum_candidates": rank_sum.rank_sum_candidates,
    "benchmark_topk": benchmark_topk.benchmark_topk,
    "gather_dot_forward_bf16": gather_dot.gather_dot_forward_bf16,
    "gather_dot_backward_bf16": gather_dot.gather_dot_backward_bf16,
    "streaming_topk_bf16": topk.streaming_topk_bf16,
    "neg_sampler_popularity": neg_sampler.sample_negatives_popularity,
    "sharded_topk_local": topk.sharded_topk_local,
    "sharded_topk_merge": topk.sharded_topk_merge,
    "conet_tower": conet_tower.conet_tower,
    "deepapf_forward": deepapf_attention.deepapf_forward,
    "deepapf_backward": deepapf_attention.deepapf_backward,
    "deepapf_grid": deepapf_attention.deepapf_grid,
    "rating_vector_forward_bf16": rating_vector.rating_vector_forward_bf16,
    "rating_vector_backward_bf16": rating_vector.rating_vector_backward_bf16,
    "graph_layer_forward_bf16": graph_layer.graph_layer_forward_bf16,
    "graph_layer_backward_bf16": graph_layer.graph_layer_backward_bf16,
    "natr_attention_forward_bf16": natr_attention.natr_attention_forward_bf16,
    "natr_attention_backward_bf16": natr_attention.natr_attention_backward_bf16,
    "natr_anchor_table_bf16": natr_attention.natr_anchor_table_bf16,
    "natr_pair_grid_bf16": natr_attention.natr_pair_grid_bf16,
    "conet_tower_bf16": conet_tower.conet_tower_bf16,
    "deepapf_forward_bf16": deepapf_attention.deepapf_forward_bf16,
    "deepapf_backward_bf16": deepapf_attention.deepapf_backward_bf16,
    "deepapf_grid_bf16": deepapf_attention.deepapf_grid_bf16,
    "group_rows": row_groups.group_rows,
    "row_sum": row_groups.row_sum,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
