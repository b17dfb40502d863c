"""Quick-start API: the end-to-end pipeline.

Port of ``recbole_cdr_tpu/quick_start/quick_start.py::run_recbole_cdr``
(capability parity with `recbole_cdr/quick_start/quick_start.py:20-130`).
"""

import logging
from logging import getLogger

from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_cdr_tpu_torch.parallel.distributed import (
    initialize_from_config,
    is_coordinator,
    shutdown,
)
from recbole_cdr_tpu_torch.trainer.trainer import eval_users
from recbole_cdr_tpu_torch.utils import (
    get_model, get_trainer, init_logger, init_seed, resolve_device, set_color,
)


def run_recbole_cdr(model=None, config_file_list=None, config_dict=None, saved=True):
    """config -> seed -> logger -> dataset -> split -> model -> trainer ->
    fit -> evaluate. Runs on ``config['device']`` ('cuda' unless the config
    asks for 'cpu'). ``saved`` keeps the best validated parameters in memory
    and evaluates the test split with them.

    Returns the JAX package's result keys plus ``history``, one record per
    trained epoch (loss, seconds, examples; validation seconds and users),
    ``test_users``, the users of the test pass, and ``model``, the trained
    module (under a mesh, this rank's shards). ``distributed`` and
    ``mesh_shape`` run it as one rank of a process group
    (``parallel/distributed.py``): every rank returns the same metrics."""
    config = CDRConfig(model=model, config_file_list=config_file_list, config_dict=config_dict)
    resolve_device(config)  # fail before any data work when the card is missing
    # the process group precedes the dataset (JAX quick_start.py:23-26); a
    # group this run creates is destroyed with it, whatever happens
    group = initialize_from_config(config)
    try:
        return _run(config, saved)
    finally:
        if group is not None:
            shutdown()


def _run(config, saved):
    init_seed(config["seed"], config["reproducibility"])
    if is_coordinator():  # only the coordinator logs
        init_logger(config)
    else:
        logging.getLogger().setLevel(logging.WARNING)
    logger = getLogger()
    logger.info(config)

    dataset = create_dataset(config)
    logger.info(dataset)
    train_data, valid_data, test_data = data_preparation(config, dataset)

    model_obj = get_model(config["model"])(config, dataset)
    trainer = get_trainer(config["MODEL_TYPE"], config["model"])(config, model_obj)

    best_valid_score, best_valid_result = trainer.fit(
        train_data, valid_data, saved=saved, show_progress=config["show_progress"],
    )
    test_result = trainer.evaluate(
        test_data, load_best_model=saved, show_progress=config["show_progress"]
    )

    logger.info(set_color("best valid ", "yellow") + f": {best_valid_result}")
    logger.info(set_color("test result", "yellow") + f": {test_result}")

    return {
        "best_valid_score": best_valid_score,
        "valid_score_bigger": config["valid_metric_bigger"],
        "best_valid_result": best_valid_result,
        "test_result": test_result,
        "history": trainer.history,
        "test_users": eval_users(test_data),
        "model": model_obj,
    }
