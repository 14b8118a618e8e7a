"""Active fine-tuning: the projection fine-tune, the partial-backbone
fine-tune, their logger and the setup shared by the active-learning
CLIs."""

from bayesvlm_tpu_torch.train.backbone import make_backbone_train_step, trainable_parameters
from bayesvlm_tpu_torch.train.finetune import evaluate_projection, finetune_projection
from bayesvlm_tpu_torch.train.logging import ExperimentLogger

__all__ = ["evaluate_projection", "finetune_projection", "ExperimentLogger",
           "make_backbone_train_step", "trainable_parameters"]
