"""NEP-SPIN descriptor and potential."""
