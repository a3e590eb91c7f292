"""Training: the train step with gradient accumulation, and DAGPS applied
to a pipeline-parallel step (ports of ``repro.train``)."""

from .pipeline import (PipelinePlan, gpipe_makespan, ideal_makespan,
                       one_f_one_b_makespan, pipeline_dag, schedule_pipeline)
from .step import (TrainConfig, init_train_state, loss_and_grads,
                   make_train_step)

__all__ = ["PipelinePlan", "TrainConfig", "gpipe_makespan",
           "ideal_makespan", "init_train_state", "loss_and_grads",
           "make_train_step", "one_f_one_b_makespan", "pipeline_dag",
           "schedule_pipeline"]
