"""The port's training stack (``repro.training``): losses, AdamW, checkpoint,
compression, the watchdog and the trainer.  Import the submodules."""
