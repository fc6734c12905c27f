"""Activation checkpointing (``checkpointing``) and its config block
(``config``)."""
