"""Training: the train and eval steps and the checkpointing trainer."""
