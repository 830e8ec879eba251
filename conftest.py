def pytest_configure(config):
    # Six test workers on eight CPUs leave each about one core: torch's
    # spinning OpenMP threads slowed a group of the port's test files 3.6x
    # and single tests up to 14x. One thread also fixes torch's CPU sum order.
    import torch

    torch.set_num_threads(1)
