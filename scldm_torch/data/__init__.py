"""The host data layer: the gene / label vocabulary encoder, tokenization of
count matrices, CSR batch packing (a native packer and its numpy path), the
DataModule and the h5ad reader and writer. numpy (and h5py / pandas inside
the functions that read files) only; tensors are made by the caller, on its
device."""
