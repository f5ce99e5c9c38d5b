"""Device barrier and stage timer (counterpart of ``eigenexa_tpu/utils``)."""
