"""Training workloads: guidance-regressor (midu) training."""

from rgie_tpu_torch.training.train_midu import (
    TrainState,
    create_train_state,
    get_noisy_latents,
    make_eval_step,
    make_optimizer,
    make_train_step,
    noisy_latents,
)
