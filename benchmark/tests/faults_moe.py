"""A fault planted under the expert layers' timed path for the tests: it
breaks the program in the way its name says, before a run starts."""


def one_slot_misrouted():
    """The first routing call sends one token-slot to the wrong expert: at
    the token whose choice is surest (the widest gap between its k-th and
    (k+1)-th scores), the last chosen expert becomes the expert it scores
    lowest."""
    import pixparse_tpu_torch.ops.moe as moe

    route = moe.route
    calls = {"n": 0}

    def misrouted(*args, **kwargs):
        r = route(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 1:
            k = r.experts.shape[1]
            top = r.scores.topk(k + 1, dim=-1).values
            t = int((top[:, k - 1] - top[:, k]).argmax())
            experts = r.experts.clone()
            experts[t, k - 1] = r.scores[t].argmin()
            r = r._replace(experts=experts)
        return r

    moe.route = misrouted
