from .train_state import (TrainState, build_lr_schedule, build_optimizer,
                          create_train_state, frozen_mask, make_train_step,
                          normalize_images)

__all__ = ['TrainState', 'build_lr_schedule', 'build_optimizer',
           'create_train_state', 'frozen_mask', 'make_train_step',
           'normalize_images']
