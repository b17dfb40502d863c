"""Data factories: dataset creation, split + dataloader preparation.

Capability parity with `recbole_cdr/data/utils.py:28-180`: the target eval
sets are full-sort (eval mode ``full``), candidate-ranking (``uniform N`` /
``popularity N``, with their own sampler when the distribution differs from
training's) or labeled (``labeled``, value metrics), routed as the JAX
package's ``data_preparation`` routes them.
"""

import os
import pickle
from logging import getLogger

import numpy as np

from recbole_cdr_tpu_torch.data.batching import CrossDomainLoader, FullSortEvalBatches
from recbole_cdr_tpu_torch.data.candidate_eval import CandidateEvalBatches
from recbole_cdr_tpu_torch.data.labeled_eval import LabeledEvalBatches
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.sampler import CrossDomainSourceSampler, DomainNegSampler
from recbole_cdr_tpu_torch.utils import set_color

#: config keys that invalidate a cached dataset artifact
dataset_arguments = [
    "seed",
    "repeatable",
    "source_domain",
    "target_domain",
    "user_link_file_path",
    "item_link_file_path",
    "eval_args",
    "train_epochs",
]


def create_dataset(config) -> CrossDomainDataset:
    """Build (or load from the artifact cache) the cross-domain dataset."""
    default_file = os.path.join(
        config["checkpoint_dir"], f"{config['dataset']}-CrossDomainDataset.pth"
    )
    file = config["dataset_save_path"] or default_file
    if os.path.exists(file):
        with open(file, "rb") as f:
            dataset = pickle.load(f)
        if all(config[a] == dataset.config[a] for a in dataset_arguments):
            getLogger().info(set_color("Load filtered dataset from", "pink") + f": [{file}]")
            return dataset

    dataset = CrossDomainDataset(config)
    if config["save_dataset"]:
        os.makedirs(os.path.dirname(file) or ".", exist_ok=True)
        with open(file, "wb") as f:
            pickle.dump(dataset, f)
    return dataset


def save_split_dataloaders(config, dataloaders):
    """Pickle the (train, valid, test) loaders (reference
    `data/utils.py:114-115` via recbole's helpers)."""
    path = config["dataloaders_save_path"] or os.path.join(
        config["checkpoint_dir"], f"{config['dataset']}-dataloaders.pth"
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"config_seed": config["seed"], "dataloaders": dataloaders}, f)


def load_split_dataloaders(config):
    path = config["dataloaders_save_path"] or os.path.join(
        config["checkpoint_dir"], f"{config['dataset']}-dataloaders.pth"
    )
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if blob.get("config_seed") != config["seed"]:
        return None
    getLogger().info(set_color("Load split dataloaders from", "pink") + f": [{path}]")
    return blob["dataloaders"]


def data_preparation(config, dataset: CrossDomainDataset):
    """Split the dataset and build the train loader + eval batch sets.

    Returns ``(train_data, valid_data, test_data)``; ``valid_data`` is a
    ``(source_valid, target_valid)`` tuple when a SOURCE phase exists.
    """
    cached = load_split_dataloaders(config) if config["save_dataloaders"] else None
    if cached is not None:
        return cached
    built = dataset.build()
    src_train, src_valid, tgt_train, tgt_valid, tgt_test = built

    distribution = config["train_neg_sample_args"]["distribution"]
    seed = config["seed"] or 0

    target_sampler = DomainNegSampler(
        ["train", "valid", "test"],
        [tgt_train, tgt_valid, tgt_test],
        num_items=dataset.num_overlap_item + dataset.num_target_only_item,
        distribution=distribution,
        seed=seed,
    )
    target_train_sampler = target_sampler.set_phase("train")

    # eval sampling may use a different distribution than training (eval mode
    # `popularity N` vs uniform train sampling — recbole's create_samplers
    # builds eval samplers from eval_neg_sample_args)
    eval_distribution = config["eval_neg_sample_args"].get("distribution", "uniform")
    if (config["eval_neg_sample_args"]["strategy"] == "by"
            and eval_distribution != distribution):
        eval_sampler = DomainNegSampler(
            ["train", "valid", "test"],
            [tgt_train, tgt_valid, tgt_test],
            num_items=dataset.num_overlap_item + dataset.num_target_only_item,
            distribution=eval_distribution,
            seed=seed,
        )
    else:
        eval_sampler = target_sampler
    target_valid_sampler = eval_sampler.set_phase("valid")
    target_test_sampler = eval_sampler.set_phase("test")

    target_item_num = dataset.num_overlap_item + dataset.num_target_only_item

    # per-item train popularity (the recbole collector's `data.count_items`),
    # consumed by AveragePopularity / TailPercentage / coverage metrics
    target_train_counts = np.bincount(
        tgt_train[tgt_train.iid_field], minlength=target_item_num
    ).astype(np.int64)

    def make_target_eval(table, sampler):
        """full-sort or candidate-ranking eval set per eval mode (the
        reference's get_dataloader routing, `data/utils.py:131-153`)."""
        eval_args = config["eval_neg_sample_args"]
        if eval_args["strategy"] == "by":
            batches = CandidateEvalBatches(
                table, sampler, neg_num=eval_args["by"], item_num=target_item_num,
                eval_batch_size=config["eval_batch_size"], seed=seed,
            )
        elif eval_args["strategy"] == "none":
            # mode `labeled`: value metrics over the split's labeled triples
            batches = LabeledEvalBatches(table, config["eval_batch_size"])
        else:
            batches = FullSortEvalBatches(
                table, sampler, target_item_num, config["eval_batch_size"]
            )
        batches.train_item_counts = target_train_counts
        return batches

    if src_valid is not None:
        source_sampler = CrossDomainSourceSampler(
            ["train", "valid"], dataset, [src_train, src_valid], distribution, seed=seed
        )
        source_train_sampler = source_sampler.set_phase("train")
        source_valid_sampler = source_sampler.set_phase("valid")
        source_item_num = dataset.num_overlap_item + dataset.num_source_only_item
        if config["eval_neg_sample_args"]["strategy"] == "none":
            raise NotImplementedError(
                "labeled (value-metric) eval is not supported together with a "
                "SOURCE training phase: source validation is ranking-based"
            )
        source_valid_data = FullSortEvalBatches(
            src_valid,
            source_valid_sampler,
            item_num=source_item_num,
            eval_batch_size=config["eval_batch_size"],
            compact=(dataset.num_overlap_item, dataset.num_target_only_item),
        )
        # source train popularity in the compacted source item-id space
        src_iids = src_train[src_train.iid_field]
        src_iids = np.where(
            src_iids < dataset.num_overlap_item,
            src_iids,
            src_iids - dataset.num_target_only_item,
        )
        source_valid_data.train_item_counts = np.bincount(
            src_iids, minlength=source_item_num
        ).astype(np.int64)
        target_valid_data = make_target_eval(tgt_valid, target_valid_sampler)
        valid_data = (source_valid_data, target_valid_data)
    else:
        source_train_sampler = CrossDomainSourceSampler(
            ["train"], dataset, [src_train], distribution, seed=seed
        ).set_phase("train")
        valid_data = make_target_eval(tgt_valid, target_valid_sampler)

    train_data = CrossDomainLoader(
        config, dataset, src_train, source_train_sampler,
        tgt_train, target_train_sampler, shuffle=True,
    )
    test_data = make_target_eval(tgt_test, target_test_sampler)

    if config["save_dataloaders"]:
        save_split_dataloaders(config, (train_data, valid_data, test_data))

    logger = getLogger()
    logger.info(
        set_color("[Training]: ", "pink")
        + f"train_batch_size = [{config['train_batch_size']}] "
        + f"negative sampling: [{config['neg_sampling']}]"
    )
    logger.info(
        set_color("[Evaluation]: ", "pink")
        + f"eval_batch_size = [{config['eval_batch_size']}] eval_args: [{config['eval_args']}]"
    )
    return train_data, valid_data, test_data
