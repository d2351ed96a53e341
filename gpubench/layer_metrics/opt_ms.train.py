"""``opt_ms.train``: the device ms of a client step's optimizer phase
(``train.optimizer`` in ``repro_torch.launch.train.make_step``, a CUDA event
pair on the step's stream) over the traced round's steps
(``train.step``)."""
from gpubench.lib import recorder


def read(ctx):
    return recorder.per_step_ms("optimizer")
