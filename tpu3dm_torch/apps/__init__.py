"""Applications on top of the library (port of tpu3dm/apps): the crash suite."""
