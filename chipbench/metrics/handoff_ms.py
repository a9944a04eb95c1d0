"""The trainer loop's own host work a step, from its spans: the data set's
``batch`` (``trainer.batch``, in the benchmark's cell also the
``StepClock``'s bookkeeping), the copy to the card
(``trainer.put_batch``), the loss read-back (``trainer.readback``) and
checkpoints (``trainer.checkpoint``), over the window's steps, in ms.
The inside twin of ``outside_step_ms``."""
from chipbench.harness import window_spans

SPANS = ("trainer.batch", "trainer.put_batch", "trainer.readback",
         "trainer.checkpoint")


def read(run):
    sp = window_spans.of_run(run)
    steps = window_spans.count(sp["window"], "trainer.step") if sp else 0
    if not steps:
        return None
    return 1e3 * window_spans.seconds(sp["window"], *SPANS) / steps
