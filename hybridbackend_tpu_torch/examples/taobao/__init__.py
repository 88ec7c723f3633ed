"""The Taobao DIN example of the port."""
