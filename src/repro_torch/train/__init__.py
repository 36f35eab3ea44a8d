"""Training on one card (the counterpart of the reference's ``train/``):
the LM loss, AdamW and Adafactor over a parameter tree, and the train and
eval steps with microbatch gradient accumulation."""
