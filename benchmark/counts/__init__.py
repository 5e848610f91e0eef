"""Operations and bytes of each kernel, one file per kernel, found by the
kernel's name (``counts/<kernel>.py``). Each defines ``per_launch(setup,
lanes, iters, n_cells) -> (operations, bytes)`` for one launch over
``lanes`` lanes at a mean of ``iters`` ADMM iterations per lane, on a track
table of ``n_cells`` cells."""
