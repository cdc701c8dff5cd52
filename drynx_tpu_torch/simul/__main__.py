"""`python -m drynx_tpu_torch.simul RUNFILE [--csv PATH|auto] [--cpu]`:
every row of a runfile through `runner.run_file` (see runner.main)."""
from .runner import main

if __name__ == "__main__":
    raise SystemExit(main())
