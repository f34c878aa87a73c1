"""Training: AdamW with int8 gradient compression, the train step and
loop, and checkpoints interchangeable with the reference's."""
