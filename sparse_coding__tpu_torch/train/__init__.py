"""Training drivers (counterpart of `sparse_coding__tpu/train`, with its
names). The drivers `sweep` and `basic_l1_sweep` keep
their submodules' names here (``from sparse_coding__tpu_torch.train import
sweep`` is the module; its function is ``sweep.sweep``)."""

from sparse_coding__tpu_torch.train.loop import (
    DriverCheckpointer,
    ensemble_train_loop,
    make_fista_decoder_update,
)
from sparse_coding__tpu_torch.train.preemption import (
    RESUMABLE_EXIT_CODE,
    Preempted,
    install_signal_handlers,
    pod_agree_preempt,
    preemption_requested,
    request_preemption,
    resume_requested,
)
from sparse_coding__tpu_torch.train.sweep import (
    filter_learned_dicts,
    format_hyperparam_val,
    init_model_dataset,
    init_synthetic_dataset,
    log_sweep_metrics,
    unstacked_to_learned_dicts,
)
from sparse_coding__tpu_torch.train.checkpoint import (
    gc_checkpoints,
    latest_checkpoint,
    load_learned_dicts,
    restore_ensemble_checkpoint,
    save_checkpoint_tree,
    save_ensemble_checkpoint,
    save_learned_dicts,
    verify_checkpoint,
)
from sparse_coding__tpu_torch.train.baselines import (
    load_baseline,
    run_all_baselines,
    run_layer_baselines,
)
from sparse_coding__tpu_torch.train import experiments
from sparse_coding__tpu_torch.train.big_batch import (
    BigBatchState,
    WorstExamples,
    make_big_batch_step,
    resurrect_dead_features,
    train_big_batch,
)
from sparse_coding__tpu_torch.train.toy_models import ToySAE, run_single_go, run_toy_grid
