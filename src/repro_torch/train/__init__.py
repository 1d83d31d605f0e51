from repro_torch.train.train_step import (
    chunked_xent_loss,
    init_train_state,
    loss_fn,
    make_train_step,
)

__all__ = ["chunked_xent_loss", "init_train_state", "loss_fn", "make_train_step"]
