"""Training and adapters on the port: the full-parameter trainer, LoRA
adapters (train, merge, artifacts) and train-state checkpoints — the JAX
package's ``agentfield_tpu.training`` without its mesh pieces (ROADMAP A5)."""

from agentfield_tpu_torch.training.lora import (  # noqa: F401
    LoRAConfig,
    init_lora_params,
    init_lora_state,
    load_adapter,
    make_lora_train_step,
    merge_lora,
    save_adapter,
)
from agentfield_tpu_torch.training.optim import adam, adamw, sgd  # noqa: F401
from agentfield_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    causal_lm_loss,
    init_train_state,
    make_lm_batch,
    make_train_step,
)
