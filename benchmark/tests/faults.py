"""Faults planted under the timed path for the tests: each breaks the
program in the way its name says, before a run starts."""


def state_unchanged():
    """The train step computes its loss and returns its state as it found
    it: no gradient, no update."""
    import torch

    import pixparse_tpu_torch.task.cruller_base as cb

    def make(loss_fn, *args, **kwargs):
        def train_step(state, batch):
            with torch.no_grad():
                loss, _ = loss_fn(batch)
            return state, {"loss": loss.detach()}

        return train_step

    cb.make_train_step = make


def half_batch():
    """Half of each batch left out; the loss is the mean over the rest."""
    import pixparse_tpu_torch.task.cruller_base as cb

    to_device = cb.BaseCrullerTrainTask._to_device

    def halved(self, batch):
        n = batch["image"].shape[0] // 2
        return to_device(self, {k: v[:n] for k, v in batch.items()})

    cb.BaseCrullerTrainTask._to_device = halved


def token_altered():
    """One served token of every page replaced where it is produced."""
    import pixparse_tpu_torch.ops.generation as gen

    select = gen.select_next
    calls = {"n": 0}

    def altered(logits, *args, **kwargs):
        calls["n"] += 1
        tok = select(logits, *args, **kwargs)
        if calls["n"] % 5 == 3:
            tok = (tok + 1) % logits.shape[-1]
        return tok

    gen.select_next = altered
