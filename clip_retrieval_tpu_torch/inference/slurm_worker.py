"""`python -m clip_retrieval_tpu_torch.inference.slurm_worker` — srun rank entry."""

from .slurm import slurm_worker

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker_args_path", required=True)
    slurm_worker(ap.parse_args().worker_args_path)
