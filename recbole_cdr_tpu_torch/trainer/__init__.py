from recbole_cdr_tpu_torch.trainer.trainer import CrossDomainTrainer, DCDCSRTrainer

__all__ = ["CrossDomainTrainer", "DCDCSRTrainer"]
