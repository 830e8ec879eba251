"""Legacy "cat/edge model" family (reference HaplotypeModel pre-v2.1 path),
the PyTorch counterpart of nanosnp_tpu/legacy.

  edges.py           vectorized edge/pair-route counting (numpy)
  bins.py            legacy .bin schema interop (HDF5 by h5py, or .npz)
  heuristic.py       vectorized two-path homozygote caller (numpy)
  labelcheck.py      read-consensus label-noise filter (numpy)
  config_archive.py  the reference's archived experiment configs
  catmodel.py        CatModel in torch: ResCRNN + percentage RNN, its three
                     BiLSTM stacks on the inference recurrence kernel
  train.py           site selection and the CatModel training pass
"""
